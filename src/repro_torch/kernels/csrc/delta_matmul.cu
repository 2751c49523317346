// Two-stage approximate matmul for Hopper (sm_90a).
//
//   S[m,n] = sum_k ( a[m,k]*b[k,n] + D[(a[m,k]+off)&255][(b[k,n]+off)&255] )
//
// Replaces the Pallas TPU kernel `delta_matmul` of the JAX package
// (src/repro/kernels/approx_matmul.py, body `_delta_matmul_kernel`,
// gather `_delta_gather`).  Its plain version is
// repro_torch.kernels.ref.delta_matmul_ref.
//
// What bounds it on this card: the stage-2 gather.  Every (m, k, n) term
// reads one 16-bit entry of the 128 KiB delta table at a data-dependent
// address, so the kernel is bound by shared-memory gathers (and their
// bank conflicts), far above both the memory bound (the operands are
// read once) and the int8 tensor-core bound.  The design answers that
// by keeping the whole table in shared memory: each CTA copies it once
// (dynamic shared memory above 48 KB needs cudaFuncSetAttribute) and
// then walks many output tiles (a persistent grid of one CTA per SM),
// so the fixed table load is paid 132 times per call, not once per tile.
// Stage 1, the exact product, is computed in the same loop from the same
// operand registers: one integer multiply-add beside each gather.
//
// Notes on exactness:
//  * Integer accumulation is exact in any order; the int32 accumulator
//    cannot overflow on the main path (K <= 6144: 6144 * 255^2 ~ 4.0e8
//    < 2^31, plus |D| <= 2^15 per term).
//  * Ragged edges are masked, not padded: the k loop stops at K, so no
//    K-padding correction is needed (the XLA twin does not pad either).
//  * The exact part multiplies the operand values; the table index is
//    masked to [0, 255] after the signed +128 shift, as in the twin.
//  * int32 tables (design 'initial', 256 KiB) do not fit; the wrapper
//    refuses them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;      // 4 groups of 128 threads
constexpr int kColThreads = 128;   // threads along n in one group
constexpr int kGroups = kThreads / kColThreads;
constexpr int kTK = 32;            // k depth of one staged tile
constexpr int kRPT = 4;            // output rows per thread
constexpr int kTableBytes = 256 * 256 * 2;

// GR row groups x (kGroups / GR) column groups.  GR = 4: a tile of
// 16 rows x 128 columns (M > 4).  GR = 1: 4 rows x 512 columns, so that
// a decode-sized M keeps all 512 threads busy.
template <int GR>
struct Tile {
  static constexpr int TM = GR * kRPT;
  static constexpr int TN = kColThreads * (kGroups / GR);
  static constexpr int kSmem = kTableBytes + TM * kTK * 4 + kTK * TN;
};

template <int GR, bool BSIGNED>
__global__ void __launch_bounds__(kThreads)
delta_matmul_kernel(const int32_t* __restrict__ a,
                    const uint8_t* __restrict__ b,
                    const int16_t* __restrict__ dlut,
                    int32_t* __restrict__ out, int M, int K, int N,
                    int offset, int tiles_n, int n_tiles, int b_vec16) {
  using T = Tile<GR>;
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* D = reinterpret_cast<int16_t*>(smem);
  int32_t* As = reinterpret_cast<int32_t*>(smem + kTableBytes);   // [TM][kTK]
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + T::TM * kTK);     // [kTK][TN]

  {  // the table, once per CTA, in 16-byte vectors
    const int4* src = reinterpret_cast<const int4*>(dlut);
    int4* dst = reinterpret_cast<int4*>(D);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += kThreads)
      dst[i] = src[i];
  }

  const int grp = threadIdx.x / kColThreads;
  const int rg = grp % GR;                      // row group
  const int col = (grp / GR) * kColThreads + threadIdx.x % kColThreads;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * T::TM;
    const int n0 = (tile % tiles_n) * T::TN;
    int acc[kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) acc[r] = 0;

    for (int k0 = 0; k0 < K; k0 += kTK) {
      __syncthreads();  // the previous step's tiles (and the table) are done
      for (int i = threadIdx.x; i < T::TM * kTK; i += kThreads) {
        const int m = m0 + i / kTK, k = k0 + i % kTK;
        As[i] = (m < M && k < K) ? a[(size_t)m * K + k] : 0;
      }
      if (b_vec16) {  // N % 16 == 0 and b 16-byte aligned
        for (int i = threadIdx.x; i < kTK * T::TN / 16; i += kThreads) {
          const int r = i / (T::TN / 16), c = (i % (T::TN / 16)) * 16;
          const int k = k0 + r, n = n0 + c;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k < K && n < N)
            v = *reinterpret_cast<const uint4*>(b + (size_t)k * N + n);
          *reinterpret_cast<uint4*>(Bs + r * T::TN + c) = v;
        }
      } else {
        for (int i = threadIdx.x; i < kTK * T::TN; i += kThreads) {
          const int k = k0 + i / T::TN, n = n0 + i % T::TN;
          Bs[i] = (k < K && n < N) ? b[(size_t)k * N + n] : 0;
        }
      }
      __syncthreads();
      const int kmax = min(kTK, K - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const int braw = Bs[kk * T::TN + col];
        const int bv = BSIGNED ? (int)(int8_t)braw : braw;
        const int ib = (bv + offset) & 255;
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const int av = As[(rg * kRPT + r) * kTK + kk];
          const int ia = (av + offset) & 255;
          acc[r] += av * bv + (int)D[(ia << 8) | ib];
        }
      }
    }
    const int n = n0 + col;
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int m = m0 + rg * kRPT + r;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[r];
    }
  }
}

template <int GR, bool BSIGNED>
cudaError_t launch(const int32_t* a, const uint8_t* b, const int16_t* dlut,
                   int32_t* out, int M, int K, int N, int offset,
                   cudaStream_t stream) {
  using T = Tile<GR>;
  auto kern = delta_matmul_kernel<GR, BSIGNED>;
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
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  kern<<<grid, kThreads, T::kSmem, stream>>>(a, b, dlut, out, M, K, N,
                                             offset, tiles_n, n_tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// a (M,K) int32, b (K,N) uint8 (b_signed=0) or int8 viewed as bytes
// (b_signed=1), dlut (256,256) int16, out (M,N) int32.  All row-major
// and contiguous.  Returns the cudaError_t of the launch.
extern "C" int delta_matmul_launch(const void* a, const void* b,
                                   const void* dlut, void* out, int M, int K,
                                   int N, int offset, int b_signed,
                                   void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto A = static_cast<const int32_t*>(a);
  auto Bp = static_cast<const uint8_t*>(b);
  auto Dp = static_cast<const int16_t*>(dlut);
  auto O = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    return b_signed ? launch<1, true>(A, Bp, Dp, O, M, K, N, offset, s)
                    : launch<1, false>(A, Bp, Dp, O, M, K, N, offset, s);
  return b_signed ? launch<4, true>(A, Bp, Dp, O, M, K, N, offset, s)
                  : launch<4, false>(A, Bp, Dp, O, M, K, N, offset, s);
}
