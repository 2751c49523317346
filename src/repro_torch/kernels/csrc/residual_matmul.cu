// Exact matmul + rank-r error correction for Hopper (sm_90a).
//
//   S[m,n] = float( sum_k a[m,k]*b[k,n] )
//            + sum_k C[(a[m,k]+off)&255][(b[k,n]+off)&255],
//   C[ia][ib] = sum_j F[ia][j] * G[j][ib]
//
// Replaces the Pallas TPU kernel `residual_matmul` of the JAX package
// (src/repro/kernels/approx_matmul.py, body `_residual_kernel`).  Its
// plain version is repro_torch.kernels.ref.residual_corrected_matmul_ref.
// F (256, r) and G (r, 256) are the rank-r SVD factors of the design's
// error surface (core.lut.error_factors; signed_error_factors with
// offset 128 for int8 operands), so the result approximates the
// approximate product; it is not bit-exact (design2's error surface has
// rank 253 unsigned, 122 signed).
//
// The rank-r correction summed over k is a gather sum over one (256, 256)
// table C = F G, so the kernel has lut_matmul.cu's structure and its cost
// no longer depends on r:
//  1. residual_table_kernel builds C for all 65,536 pairs, each entry a
//     float64 sum of r exact float products rounded once to float32 (r
//     FMAs an entry: microseconds even at r = 256), into a scratch the
//     wrapper allocates.  It runs on every call, on the caller's stream.
//  2. residual_matmul_kernel is lut_matmul.cu's persistent grid and tile
//     layout (staged 64 deep, not 32: two sweeps per tile double the
//     stages), with an int32 exact accumulator (a*b, converted once at
//     the end) and a float32 correction accumulator per output.
//
// What bounds it on this card: shared-memory gathers, one 4-byte entry of
// C at a data-dependent address per (m, k, n) term, as in lut_matmul.
// A float32 C is 256 KiB, more than a block's 227 KB, so it is held in
// two halves of 128 KiB by the high bit of ia.  Each tile sweeps K with
// one half resident, then with the other; the accumulators stay in
// registers and every term is gathered exactly once.  ia depends on
// (m, k) only, and a warp's threads share their rows, so the half test is
// a warp-uniform branch.  The halves come in by a bulk copy on an
// mbarrier and the a/b tiles by cp.async into a double buffer, so the
// next loads overlap the gathers; successive tiles of a CTA alternate the
// sweep order (0,1 then 1,0), so the resident half carries over and one
// half is loaded per tile.  (A 2-CTA cluster holding one half each in
// distributed shared memory is the alternative; the two sweeps keep every
// gather local.)
//
// Exactness: the exact part is an int32 sum converted once (K * 255^2 <
// 2^31 for K <= 33025), equal to the plain version's integer product
// converted to float32.  C is rounded once from a float64 sum; the plain
// version sums the correction as an einsum over (k, j) in float32.  So
// the float32 sum over k (taken here half by half, k ascending in each)
// and C's rounding are the only differences from the plain version.
// Ragged edges are masked; zero-filled rows are never stored.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

namespace ac = async_copy;

constexpr int kThreads = 512;      // 4 groups of 128 threads
constexpr int kColThreads = 128;   // threads along n in one group
constexpr int kGroups = kThreads / kColThreads;
constexpr int kTK = 64;            // k depth of one staged tile
constexpr int kRPT = 4;            // output rows per thread
constexpr int kHalfRows = 128;     // rows of C per resident half
constexpr int kHalfBytes = kHalfRows * 256 * 4;

// lut_matmul.cu's layouts: GR = 4, a tile of 16 rows x 128 columns;
// GR = 1, 4 rows x 512 columns (M <= 4).
template <int GR>
struct Tile {
  static constexpr int TM = GR * kRPT;
  static constexpr int TN = kColThreads * (kGroups / GR);
  static constexpr int kA = TM * kTK;         // a entries of one stage
  static constexpr int kB = kTK * TN;         // b bytes of one stage
  // C half, a double buffer, the half-local indices, b double buffer,
  // the mbarrier
  static constexpr int kSmem = kHalfBytes + 2 * kA * 4 + kA * 4 + 2 * kB + 16;
};

__global__ void __launch_bounds__(256)
residual_table_kernel(const float* __restrict__ F,
                      const float* __restrict__ G, float* __restrict__ C,
                      int r) {
  __shared__ float Fs[256];
  const int ia = blockIdx.x, ib = threadIdx.x;
  for (int j = threadIdx.x; j < r; j += blockDim.x) Fs[j] = F[ia * r + j];
  __syncthreads();
  double acc = 0.0;   // float products are exact in float64
  for (int j = 0; j < r; ++j)
    acc = __fma_rn((double)Fs[j], (double)G[j * 256 + ib], acc);
  C[ia * 256 + ib] = __double2float_rn(acc);
}

template <int GR, bool BSIGNED>
__global__ void __launch_bounds__(kThreads)
residual_matmul_kernel(const int32_t* __restrict__ a,
                       const uint8_t* __restrict__ b,
                       const float* __restrict__ C,
                       float* __restrict__ out, int M, int K, int N,
                       int offset, int tiles_n, int n_tiles, int a_vec16,
                       int b_vec16) {
  using T = Tile<GR>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ch = reinterpret_cast<float*>(smem);               // [128][256]
  int32_t* As = reinterpret_cast<int32_t*>(smem + kHalfBytes);  // [2][TM][kTK]
  int32_t* Ax = As + 2 * T::kA;                             // [TM][kTK]
  uint8_t* Bs = reinterpret_cast<uint8_t*>(Ax + T::kA);     // [2][kTK][TN]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + 2 * T::kB);

  if (threadIdx.x == 0) ac::bar_init(bar);
  __syncthreads();

  const int grp = threadIdx.x / kColThreads;
  const int rg = grp % GR;                      // row group
  const int col = (grp / GR) * kColThreads + threadIdx.x % kColThreads;
  const int nk = (K + kTK - 1) / kTK;

  // cp.async of the a and b tiles of k0 into buffer `buf`, one group
  auto stage = [&](int m0, int n0, int k0, int buf) {
    int32_t* Ad = As + buf * T::kA;
    uint8_t* Bd = Bs + buf * T::kB;
    if (a_vec16) {  // K % 4 == 0 and a 16-byte aligned
      for (int i = threadIdx.x; i < T::kA / 4; i += kThreads) {
        const int m = m0 + i / (kTK / 4), k = k0 + (i % (kTK / 4)) * 4;
        const bool in = m < M && k < K;
        ac::cp16(Ad + i * 4, in ? a + (size_t)m * K + k : a, in);
      }
    } else {
      for (int i = threadIdx.x; i < T::kA; i += kThreads) {
        const int m = m0 + i / kTK, k = k0 + i % kTK;
        const bool in = m < M && k < K;
        ac::cp4(Ad + i, in ? a + (size_t)m * K + k : a, in);
      }
    }
    if (b_vec16) {  // N % 16 == 0 and b 16-byte aligned
      for (int i = threadIdx.x; i < T::kB / 16; i += kThreads) {
        const int r = i / (T::TN / 16), c = (i % (T::TN / 16)) * 16;
        const int k = k0 + r, n = n0 + c;
        const bool in = k < K && n < N;
        ac::cp16(Bd + r * T::TN + c, in ? b + (size_t)k * N + n : b, in);
      }
    } else {
      for (int i = threadIdx.x; i < T::kB; i += kThreads) {
        const int k = k0 + i / T::TN, n = n0 + i % T::TN;
        Bd[i] = (k < K && n < N) ? b[(size_t)k * N + n] : 0;
      }
    }
    ac::commit();
  };

  // Ax = a's row index into resident half h, or -1 for the other half.
  // Each thread converts the a entries it copied itself (visible to it
  // after its wait), so the next __syncthreads publishes both.
  auto index = [&](int buf, int h) {
    const int32_t* Ar = As + buf * T::kA;
    const int per = a_vec16 ? 4 : 1;
    for (int i = threadIdx.x * per; i < T::kA; i += kThreads * per) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= per) break;
        const int ia = (Ar[i + e] + offset) & 255;
        Ax[i + e] = (ia >> 7) == h ? (ia & 127) << 8 : -1;
      }
    }
  };

  int resident = -1;       // the half of C in shared memory
  uint32_t parity = 0;     // of the mbarrier's next phase
  int j = 0;               // this CTA's tile count
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const int m0 = (tile / tiles_n) * T::TM;
    const int n0 = (tile % tiles_n) * T::TN;
    int iacc[kRPT];
    float cacc[kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      iacc[r] = 0;
      cacc[r] = 0.f;
    }
    for (int s = 0; s < 2; ++s) {
      const int h = (j & 1) ? 1 - s : s;
      // every thread is past the last sweep's final __syncthreads
      bool table_in_flight = false;
      if (h != resident) {
        if (threadIdx.x == 0)
          ac::bulk_load(Ch, C + (size_t)h * kHalfRows * 256, kHalfBytes,
                        bar);
        resident = h;
        table_in_flight = true;
      }
      stage(m0, n0, 0, 0);
      for (int step = 0; step < nk; ++step) {
        const int buf = step & 1;
        if (step + 1 < nk) stage(m0, n0, (step + 1) * kTK, buf ^ 1);
        else ac::commit();
        ac::wait<1>();
        index(buf, h);
        if (table_in_flight) {
          ac::bar_wait(bar, parity);
          parity ^= 1;
          table_in_flight = false;
        }
        __syncthreads();
        const int32_t* Ar = As + buf * T::kA;
        const uint8_t* Br = Bs + buf * T::kB;
        const int kmax = min(kTK, K - step * kTK);
        if (s == 0) {  // the exact part, once per tile
#pragma unroll 4
          for (int kk = 0; kk < kmax; ++kk) {
            const int braw = Br[kk * T::TN + col];
            const int bv = BSIGNED ? (int)(int8_t)braw : braw;
            const int ib = (bv + offset) & 255;
#pragma unroll
            for (int r = 0; r < kRPT; ++r) {
              const int row = (rg * kRPT + r) * kTK + kk;
              iacc[r] += Ar[row] * bv;
              const int x = Ax[row];
              if (x >= 0) cacc[r] = __fadd_rn(cacc[r], Ch[x | ib]);
            }
          }
        } else {
#pragma unroll 4
          for (int kk = 0; kk < kmax; ++kk) {
            const int braw = Br[kk * T::TN + col];
            const int bv = BSIGNED ? (int)(int8_t)braw : braw;
            const int ib = (bv + offset) & 255;
#pragma unroll
            for (int r = 0; r < kRPT; ++r) {
              const int x = Ax[(rg * kRPT + r) * kTK + kk];
              if (x >= 0) cacc[r] = __fadd_rn(cacc[r], Ch[x | ib]);
            }
          }
        }
        __syncthreads();   // done with this stage's buffers and Ax
      }
    }
    // out = float(exact) + correction, as the plain version
    const int n = n0 + col;
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int m = m0 + rg * kRPT + r;
      if (m < M && n < N)
        out[(size_t)m * N + n] = __fadd_rn((float)iacc[r], cacc[r]);
    }
  }
}

template <int GR, bool BSIGNED>
cudaError_t launch(const int32_t* a, const uint8_t* b, const float* C,
                   float* out, int M, int K, int N, int offset,
                   cudaStream_t stream) {
  using T = Tile<GR>;
  auto kern = residual_matmul_kernel<GR, BSIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + T::TN - 1) / T::TN;
  const int n_tiles = ((M + T::TM - 1) / T::TM) * tiles_n;
  const int grid = n_tiles < sms ? n_tiles : sms;
  const int avec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const int bvec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  kern<<<grid, kThreads, T::kSmem, stream>>>(a, b, C, out, M, K, N, offset,
                                             tiles_n, n_tiles, avec, bvec);
  return cudaGetLastError();
}

}  // namespace

// a (M,K) int32, b (K,N) uint8 (b_signed=0) or int8 viewed as bytes
// (b_signed=1), F (256,r) and G (r,256) float32 with 1 <= r <= 256,
// C a (256,256) float32 scratch (16-byte aligned) that receives F G,
// out (M,N) float32.  All row-major and contiguous; offset 0 or 128.
// Two launches on `stream`, the table then the product.  Returns the
// cudaError_t of the launches.
extern "C" int residual_matmul_launch(const void* a, const void* b,
                                      const void* F, const void* G, void* C,
                                      void* out, int M, int K, int N, int r,
                                      int offset, int b_signed,
                                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (r < 1 || r > 256) return (int)cudaErrorInvalidValue;
  auto A = static_cast<const int32_t*>(a);
  auto Bp = static_cast<const uint8_t*>(b);
  auto Cp = static_cast<float*>(C);
  auto O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  residual_table_kernel<<<256, 256, 0, s>>>(static_cast<const float*>(F),
                                            static_cast<const float*>(G), Cp,
                                            r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (K <= 0)
    return (int)cudaMemsetAsync(O, 0, (size_t)M * N * sizeof(float), s);
  if (M <= 4)
    return b_signed ? launch<1, true>(A, Bp, Cp, O, M, K, N, offset, s)
                    : launch<1, false>(A, Bp, Cp, O, M, K, N, offset, s);
  return b_signed ? launch<4, true>(A, Bp, Cp, O, M, K, N, offset, s)
                  : launch<4, false>(A, Bp, Cp, O, M, K, N, offset, s);
}
