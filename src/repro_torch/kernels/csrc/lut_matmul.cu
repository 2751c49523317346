// Product-LUT gather matmul for Hopper (sm_90a).
//
//   S[m,n] = sum_k LUT[(a[m,k]+off)&255][(b[k,n]+off)&255]     (int32)
//
// Replaces the Pallas TPU kernel `lut_matmul` of the JAX package
// (src/repro/kernels/approx_matmul.py, body `_lut_matmul_kernel`).  Its
// plain version is repro_torch.kernels.ref.approx_matmul_ref (with
// off = 0, lut_matmul_ref).  The Pallas function is offset-free; this
// kernel takes the offset as delta_matmul does, so signed operands come
// as they are (a int32, b int8, off = 128) and no pre-shifted copy is
// made.
//
// What bounds it on this card: the gather.  Every (m, k, n) term reads one
// table entry at a data-dependent address, so the kernel is bound by
// shared-memory gathers and their bank conflicts, far above both the
// memory bound (each operand is read once) and the int8 tensor-core
// bound of the same M*K*N products.  The TPU kernel pins the 256 KiB int32
// table in VMEM; a Hopper block has at most 227 KB of shared memory, so
// the table is narrowed to 16 bits (128 KiB) and widened again in the
// accumulator: uint16 for tables whose values lie in [0, 65535] (every
// unsigned product LUT: 0..65025), int16 for [-32768, 32767] (every
// signed LUT: -16774..16384).  The wrapper checks the range and refuses a
// table that fits neither.
//
// Design: a persistent grid of at most one CTA per SM, each with the
// table in shared memory (one bulk copy on an mbarrier, overlapping the
// first operand loads), walks output tiles of 32 rows x 128 columns.  Its
// 512 threads are 4 row groups x 128 columns; a thread sums 8 rows of one
// column.  Operands are staged 64 deep into a double buffer as one run of
// (tile, k step) steps, so the next step (of this tile or the next)
// loads while the current one is gathered: b by cp.async, a by 16-byte
// loads into registers that are packed into bytes, with the offset
// folded in, after the current step's gathers.  The gathers themselves
// are gather_loop.cuh's loop: one LDS.16 and three integer instructions
// per term.
//
// Exactness: integer sums in any order; K * 65535 < 2^31 for K <= 32768.
// Ragged edges are masked (the k loop stops at K; rows and columns
// beyond M and N are summed but not stored), so any shape works.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "gather_loop.cuh"

namespace {

namespace ac = async_copy;
namespace gl = gather_loop;

constexpr int kThreads = 512;
constexpr int kCols = 128;                  // threads along n (= TN)
constexpr int kGroups = kThreads / kCols;   // row groups
constexpr int kRPT = 8;                     // rows per thread
constexpr int kTM = kGroups * kRPT;         // 32
constexpr int kTN = kCols;                  // 128
constexpr int kTK = 64;                     // k depth of one staged step
constexpr int kStageA = kTM * kTK;          // a bytes of a step
constexpr int kStageB = kTK * kTN;          // b bytes of a step
constexpr int kSmem = gl::kTableBytes + 2 * kStageA + 2 * kStageB + 16;
static_assert(kStageB / 16 == kThreads, "one 16-byte b copy a thread");
static_assert(kStageA / 4 == kThreads, "four a entries a thread");

template <bool UNSIGNED>
__global__ void __launch_bounds__(kThreads, 1)
lut_matmul_kernel(const int32_t* __restrict__ a,
                  const uint8_t* __restrict__ b,
                  const uint16_t* __restrict__ lut,
                  int32_t* __restrict__ out, int M, int K, int N, int offset,
                  int tiles_n, int n_tiles, int a_vec16, int b_vec16) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* As = smem + gl::kTableBytes;           // [2][kTM][kTK]
  uint8_t* Bs = As + 2 * kStageA;                 // [2][kTK][kTN]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + 2 * kStageB);
  const uint32_t tab = ac::smem_addr(smem);

  const int tid = threadIdx.x;
  const int rg = tid / kCols, col = tid % kCols;
  const int stages = K > 0 ? (K + kTK - 1) / kTK : 1;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = my_tiles * stages;

  if (tid == 0) ac::bar_init(bar);
  __syncthreads();
  if (tid == 0) ac::bulk_load(smem, lut, gl::kTableBytes, bar);

  auto origin = [&](int s, int& m0, int& n0, int& k0) {
    const int tile = blockIdx.x + (s / stages) * gridDim.x;
    m0 = (tile / tiles_n) * kTM;
    n0 = (tile % tiles_n) * kTN;
    k0 = (s % stages) * kTK;
  };
  // b of step s into buffer buf: one 16-byte cp.async a thread
  auto stage_b = [&](int s, int buf) {
    int m0, n0, k0;
    origin(s, m0, n0, k0);
    uint8_t* Bd = Bs + buf * kStageB;
    if (b_vec16) {  // N % 16 == 0 and b 16-byte aligned
      const int r = tid / (kTN / 16), c = (tid % (kTN / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < K && n < N;
      ac::cp16(Bd + r * kTN + c, in ? b + (size_t)k * N + n : b, in);
    } else {
      for (int i = tid; i < kStageB; i += kThreads) {
        const int k = k0 + i / kTN, n = n0 + i % kTN;
        Bd[i] = (k < K && n < N) ? b[(size_t)k * N + n] : 0;
      }
    }
    ac::commit();
  };
  // a of step s: four consecutive k of one row a thread, into registers
  const int ar = tid / (kTK / 4), ac4 = (tid % (kTK / 4)) * 4;
  auto fetch_a = [&](int s) {
    int m0, n0, k0;
    origin(s, m0, n0, k0);
    const int m = m0 + ar, k = k0 + ac4;
    int4 v = make_int4(0, 0, 0, 0);
    if (m < M) {
      const int32_t* p = a + (size_t)m * K + k;
      if (a_vec16) {  // K % 4 == 0 and a 16-byte aligned
        if (k < K) v = *reinterpret_cast<const int4*>(p);
      } else {
        if (k < K) v.x = p[0];
        if (k + 1 < K) v.y = p[1];
        if (k + 2 < K) v.z = p[2];
        if (k + 3 < K) v.w = p[3];
      }
    }
    return v;
  };
  // ... packed into the row's bytes of buffer buf, (a + offset) & 255
  auto store_a = [&](int4 v, int buf) {
    const uint32_t w = ((uint32_t)(v.x + offset) & 255u)
        | (((uint32_t)(v.y + offset) & 255u) << 8)
        | (((uint32_t)(v.z + offset) & 255u) << 16)
        | (((uint32_t)(v.w + offset) & 255u) << 24);
    *reinterpret_cast<uint32_t*>(As + buf * kStageA + ar * kTK + ac4) = w;
  };

  int acc[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) acc[r] = 0;

  stage_b(0, 0);
  store_a(fetch_a(0), 0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < steps;
    int4 next_a = make_int4(0, 0, 0, 0);
    if (more) {
      stage_b(s + 1, buf ^ 1);
      next_a = fetch_a(s + 1);    // in flight while this step is gathered
    } else {
      ac::commit();
    }
    ac::wait<1>();
    if (s == 0) ac::bar_wait(bar, 0);
    __syncthreads();               // step s's a and b are in
    int m0, n0, k0;
    origin(s, m0, n0, k0);
    if (m0 + rg * kRPT < M)        // warp-uniform: rows of this group
      gl::gather_run<kRPT, UNSIGNED, 0>(
          tab, As + buf * kStageA + rg * kRPT * kTK, kTK,
          Bs + buf * kStageB + col, kTN, min(kTK, K - k0), 0u, offset, acc);
    if (more) store_a(next_a, buf ^ 1);
    if (s % stages == stages - 1) {
      const int n = n0 + col;
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        const int m = m0 + rg * kRPT + r;
        if (m < M && n < N) out[(size_t)m * N + n] = acc[r];
        acc[r] = 0;
      }
    }
    __syncthreads();               // done with buffer buf
  }
}

template <bool UNSIGNED>
cudaError_t launch(const int32_t* a, const uint8_t* b, const uint16_t* lut,
                   int32_t* out, int M, int K, int N, int offset,
                   cudaStream_t stream) {
  auto kern = lut_matmul_kernel<UNSIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + kTN - 1) / kTN;
  const int n_tiles = ((M + kTM - 1) / kTM) * tiles_n;
  const int grid = n_tiles < sms ? n_tiles : sms;
  const int avec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const int bvec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  kern<<<grid, kThreads, kSmem, stream>>>(a, b, lut, out, M, K, N, offset,
                                          tiles_n, n_tiles, avec, bvec);
  return cudaGetLastError();
}

}  // namespace

// a (M,K) int32; b (K,N) bytes (uint8, or int8 viewed as bytes); lut
// (256,256) 16-bit entries, 16-byte aligned (read as uint16 when
// lut_unsigned, else as int16); out (M,N) int32.  The table index is
// ((a + offset) & 255, (b + offset) & 255).  All row-major and
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int lut_matmul_launch(const void* a, const void* b,
                                 const void* lut, void* out, int M, int K,
                                 int N, int lut_unsigned, int offset,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto A = static_cast<const int32_t*>(a);
  auto Bp = static_cast<const uint8_t*>(b);
  auto Lp = static_cast<const uint16_t*>(lut);
  auto O = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return lut_unsigned ? launch<true>(A, Bp, Lp, O, M, K, N, offset, s)
                      : launch<false>(A, Bp, Lp, O, M, K, N, offset, s);
}
