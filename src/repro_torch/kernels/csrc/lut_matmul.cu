// Product-LUT gather matmul for Hopper (sm_90a).
//
//   S[m,n] = sum_k LUT[a[m,k]][b[k,n]]          (int32, bit-exact)
//
// Replaces the Pallas TPU kernel `lut_matmul` of the JAX package
// (src/repro/kernels/approx_matmul.py, body `_lut_matmul_kernel`).  Its
// plain version is repro_torch.kernels.ref.lut_matmul_ref.  Offset-free,
// as the Pallas function: signed operands arrive pre-shifted by +128
// (ops.approx_matmul does that for the 'xla' / 'pallas_legacy' backends).
//
// What bounds it on this card: the gather.  Every (m, k, n) term reads one
// table entry at a data-dependent address, so the kernel is bound by
// shared-memory gathers (and their bank conflicts), far above both the
// memory bound (each operand is read once) and the int8 tensor-core
// bound of the same M*K*N products.  The TPU kernel pins the 256 KiB int32
// table in VMEM; a Hopper block has at most 227 KB of shared memory, so
// the table is narrowed to 16 bits (128 KiB) and widened again in the
// accumulator: uint16 for tables whose values lie in [0, 65535] (every
// unsigned product LUT: 0..65025), int16 for [-32768, 32767] (every
// signed LUT: -16774..16384).  The wrapper checks the range and refuses a
// table that fits neither.  The rest is delta_matmul.cu's design: each
// CTA copies the table once and walks many output tiles (a persistent
// grid of one CTA per SM), so the table load is paid 132 times per call.
//
// Exactness: integer sums in any order; K * 65535 < 2^31 for K <= 32768.
// Ragged edges are masked, so any shape works (the Pallas kernel's
// block-multiple assert is a constraint of Pallas, not of the function).
// Operand values are masked to [0, 255] before they index the table.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;      // 4 groups of 128 threads
constexpr int kColThreads = 128;   // threads along n in one group
constexpr int kGroups = kThreads / kColThreads;
constexpr int kTK = 32;            // k depth of one staged tile
constexpr int kRPT = 4;            // output rows per thread
constexpr int kTableBytes = 256 * 256 * 2;

// GR row groups x (kGroups / GR) column groups: GR = 4 gives a tile of
// 16 rows x 128 columns, GR = 1 a tile of 4 rows x 512 columns (M <= 4).
template <int GR>
struct Tile {
  static constexpr int TM = GR * kRPT;
  static constexpr int TN = kColThreads * (kGroups / GR);
  static constexpr int kSmem = kTableBytes + TM * kTK * 4 + kTK * TN;
};

template <int GR, bool UNSIGNED>
__global__ void __launch_bounds__(kThreads)
lut_matmul_kernel(const int32_t* __restrict__ a,
                  const uint8_t* __restrict__ b,
                  const uint16_t* __restrict__ lut,
                  int32_t* __restrict__ out, int M, int K, int N,
                  int tiles_n, int n_tiles, int b_vec16) {
  using T = Tile<GR>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* L = reinterpret_cast<uint16_t*>(smem);
  int32_t* As = reinterpret_cast<int32_t*>(smem + kTableBytes);   // [TM][kTK]
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + T::TM * kTK);     // [kTK][TN]

  {  // the table, once per CTA, in 16-byte vectors
    const int4* src = reinterpret_cast<const int4*>(lut);
    int4* dst = reinterpret_cast<int4*>(L);
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
        // the row half of the table index, a * 256
        As[i] = (m < M && k < K) ? (a[(size_t)m * K + k] & 255) << 8 : 0;
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
        const int ib = Bs[kk * T::TN + col];
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const uint16_t e = L[As[(rg * kRPT + r) * kTK + kk] | ib];
          acc[r] += UNSIGNED ? (int)e : (int)(int16_t)e;
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

template <int GR, bool UNSIGNED>
cudaError_t launch(const int32_t* a, const uint8_t* b, const uint16_t* lut,
                   int32_t* out, int M, int K, int N, cudaStream_t stream) {
  using T = Tile<GR>;
  auto kern = lut_matmul_kernel<GR, UNSIGNED>;
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
  kern<<<grid, kThreads, T::kSmem, stream>>>(a, b, lut, out, M, K, N,
                                             tiles_n, n_tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// a (M,K) int32 in [0,255], b (K,N) uint8, lut (256,256) 16-bit entries
// (read as uint16 when lut_unsigned, else as int16), out (M,N) int32.
// All row-major and contiguous.  Returns the cudaError_t of the launch.
extern "C" int lut_matmul_launch(const void* a, const void* b,
                                 const void* lut, void* out, int M, int K,
                                 int N, int lut_unsigned, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto A = static_cast<const int32_t*>(a);
  auto Bp = static_cast<const uint8_t*>(b);
  auto Lp = static_cast<const uint16_t*>(lut);
  auto O = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    return lut_unsigned ? launch<1, true>(A, Bp, Lp, O, M, K, N, s)
                        : launch<1, false>(A, Bp, Lp, O, M, K, N, s);
  return lut_unsigned ? launch<4, true>(A, Bp, Lp, O, M, K, N, s)
                      : launch<4, false>(A, Bp, Lp, O, M, K, N, s);
}
