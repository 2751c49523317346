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
// by keeping the whole table in shared memory and paying its copy once
// per CTA, with at most one CTA per SM.  Stage 1, the exact product, is
// computed in the same loop from the same operand registers: one integer
// multiply-add beside each gather.  Two schedules:
//  * M > 4 (tile_kernel): a persistent grid walks output tiles of 16 rows
//    x 128 columns, each over the whole of K.
//  * M <= 4 (small_m_kernel): a decode or calibration call has only N/128
//    output tiles of 4 rows, 8-48 at the main path's widths, so tiles
//    alone would leave most of the 132 SMs idle and walk K serially.  The
//    (tile, 64-deep k chunk) units are split evenly over one CTA per SM
//    (stream-K, async_copy.cuh): each CTA sums a contiguous run of units
//    and adds its int32 partials into the output with atomicAdd (the
//    launcher zeroes it first, on the same stream).  Inside a CTA the 4
//    thread groups split each chunk's k and their partials meet in shared
//    memory.  The table comes in by one bulk copy on an mbarrier while the
//    first a/b tiles load by cp.async into a double buffer, and each next
//    chunk loads while the current one is gathered.
//
// Notes on exactness:
//  * Integer accumulation is exact in any order (atomics included), so
//    the result is bit-exact and the same from run to run; the int32
//    accumulator cannot overflow on the main path (K <= 6144: 6144 *
//    255^2 ~ 4.0e8 < 2^31, plus |D| <= 2^15 per term).
//  * Ragged edges are masked, not padded: the k loops stop at K, so no
//    K-padding correction is needed (the XLA twin does not pad either).
//    Zero-filled rows beyond M are summed but never stored.
//  * The exact part multiplies the operand values; the table index is
//    masked to [0, 255] after the signed +128 shift, as in the twin.
//  * The table is 16 bits wide: int16, or, for a design whose delta range
//    fits 16 bits only after a shift (the unsigned 'initial', D in
//    [-48744, 0]), uint16 entries T = D + bias (ops.narrow_delta).  The
//    biased sums are exact in int32 arithmetic modulo 2^32, and each
//    output subtracts K * bias once (tile_kernel at its store; the split-K
//    CTAs bias * their k count per unit), so the result is D's sum.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

namespace ac = async_copy;

constexpr int kThreads = 512;      // 4 groups of 128 threads
constexpr int kColThreads = 128;   // threads along n in one group
constexpr int kGroups = kThreads / kColThreads;
constexpr int kRPT = 4;            // output rows per thread
constexpr int kTableBytes = 256 * 256 * 2;

// tile_kernel (M > 4): 4 row groups of 128 threads, a tile of 16 rows x
// 128 columns, staged 32 deep.
constexpr int kTM = kGroups * kRPT;
constexpr int kTN = kColThreads;
constexpr int kTK = 32;
constexpr int kTileSmem = kTableBytes + kTM * kTK * 4 + kTK * kTN;

// U16: the table's entries read as uint16 (a biased table), else int16
template <bool U16>
__device__ __forceinline__ int term(int av, int bv, int ib, int offset,
                                    const int16_t* D) {
  const int ia = (av + offset) & 255;
  const int16_t d = D[(ia << 8) | ib];
  return av * bv + (U16 ? (int)(uint16_t)d : (int)d);
}

template <bool BSIGNED, bool U16>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int32_t* __restrict__ a, const uint8_t* __restrict__ b,
            const int16_t* __restrict__ dlut, int32_t* __restrict__ out,
            int M, int K, int N, int offset, int tiles_n, int n_tiles,
            int b_vec16, int kbias) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* D = reinterpret_cast<int16_t*>(smem);
  int32_t* As = reinterpret_cast<int32_t*>(smem + kTableBytes);   // [kTM][kTK]
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + kTM * kTK);       // [kTK][kTN]

  {  // the table, once per CTA, in 16-byte vectors
    const int4* src = reinterpret_cast<const int4*>(dlut);
    int4* dst = reinterpret_cast<int4*>(D);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += kThreads)
      dst[i] = src[i];
  }

  const int rg = threadIdx.x / kColThreads;     // row group
  const int col = threadIdx.x % kColThreads;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kTM;
    const int n0 = (tile % tiles_n) * kTN;
    int acc[kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) acc[r] = 0;

    for (int k0 = 0; k0 < K; k0 += kTK) {
      __syncthreads();  // the previous step's tiles (and the table) are done
      for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
        const int m = m0 + i / kTK, k = k0 + i % kTK;
        As[i] = (m < M && k < K) ? a[(size_t)m * K + k] : 0;
      }
      if (b_vec16) {  // N % 16 == 0 and b 16-byte aligned
        for (int i = threadIdx.x; i < kTK * kTN / 16; i += kThreads) {
          const int r = i / (kTN / 16), c = (i % (kTN / 16)) * 16;
          const int k = k0 + r, n = n0 + c;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k < K && n < N)
            v = *reinterpret_cast<const uint4*>(b + (size_t)k * N + n);
          *reinterpret_cast<uint4*>(Bs + r * kTN + c) = v;
        }
      } else {
        for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
          const int k = k0 + i / kTN, n = n0 + i % kTN;
          Bs[i] = (k < K && n < N) ? b[(size_t)k * N + n] : 0;
        }
      }
      __syncthreads();
      const int kmax = min(kTK, K - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const int braw = Bs[kk * kTN + col];
        const int bv = BSIGNED ? (int)(int8_t)braw : braw;
        const int ib = (bv + offset) & 255;
#pragma unroll
        for (int r = 0; r < kRPT; ++r)
          acc[r] += term<U16>(As[(rg * kRPT + r) * kTK + kk], bv, ib, offset,
                              D);
      }
    }
    const int n = n0 + col;
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int m = m0 + rg * kRPT + r;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[r] - kbias;
    }
  }
}

// small_m_kernel (M <= 4): a tile of 4 rows x 128 columns, one unit a
// 64-deep k chunk of it; thread group g takes k [16g, 16g + 16) of each
// chunk for the tile's 128 columns and all 4 rows.
constexpr int kSmallTN = kColThreads;
constexpr int kChunk = 64;
constexpr int kKPerGroup = kChunk / kGroups;
constexpr int kSmallA = kRPT * kChunk;        // a entries of one chunk
constexpr int kSmallB = kChunk * kSmallTN;    // b bytes of one chunk
// table, a and b double buffers, the groups' partials, the mbarrier
constexpr int kSmallSmem = kTableBytes + 2 * kSmallA * 4 + 2 * kSmallB
    + kGroups * kRPT * kSmallTN * 4 + 16;
static_assert(kThreads / kSmallTN == kRPT, "one reducing thread an output");

template <bool BSIGNED, bool U16>
__global__ void __launch_bounds__(kThreads)
small_m_kernel(const int32_t* __restrict__ a, const uint8_t* __restrict__ b,
               const int16_t* __restrict__ dlut, int32_t* __restrict__ out,
               int M, int K, int N, int offset, ac::StreamK sk, int a_vec16,
               int b_vec16, int bias) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* D = reinterpret_cast<int16_t*>(smem);
  // a [2][4][kChunk], b [2][kChunk][128], partials [group][row][128]
  int32_t* As = reinterpret_cast<int32_t*>(smem + kTableBytes);
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + 2 * kSmallA);
  int32_t* Red = reinterpret_cast<int32_t*>(Bs + 2 * kSmallB);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(Red + kGroups * kRPT * kSmallTN);

  const long long u0 = sk.begin(blockIdx.x), u1 = sk.begin(blockIdx.x + 1);
  if (threadIdx.x == 0) ac::bar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) ac::bulk_load(D, dlut, kTableBytes, bar);

  // cp.async of unit u's a and b chunks into buffer `buf`, one group
  auto stage = [&](long long u, int buf) {
    const int n0 = (int)(u / sk.chunks) * kSmallTN;
    const int k0 = (int)(u % sk.chunks) * kChunk;
    int32_t* Ad = As + buf * kSmallA;
    uint8_t* Bd = Bs + buf * kSmallB;
    if (a_vec16) {  // K % 4 == 0 and a 16-byte aligned
      for (int i = threadIdx.x; i < kSmallA / 4; i += kThreads) {
        const int m = i / (kChunk / 4), k = k0 + (i % (kChunk / 4)) * 4;
        const bool in = m < M && k < K;
        ac::cp16(Ad + i * 4, in ? a + (size_t)m * K + k : a, in);
      }
    } else {
      for (int i = threadIdx.x; i < kSmallA; i += kThreads) {
        const int m = i / kChunk, k = k0 + i % kChunk;
        const bool in = m < M && k < K;
        ac::cp4(Ad + i, in ? a + (size_t)m * K + k : a, in);
      }
    }
    if (b_vec16) {  // N % 16 == 0 and b 16-byte aligned
      for (int i = threadIdx.x; i < kSmallB / 16; i += kThreads) {
        const int r = i / (kSmallTN / 16), c = (i % (kSmallTN / 16)) * 16;
        const int k = k0 + r, n = n0 + c;
        const bool in = k < K && n < N;
        ac::cp16(Bd + r * kSmallTN + c, in ? b + (size_t)k * N + n : b, in);
      }
    } else {
      for (int i = threadIdx.x; i < kSmallB; i += kThreads) {
        const int k = k0 + i / kSmallTN, n = n0 + i % kSmallTN;
        Bd[i] = (k < K && n < N) ? b[(size_t)k * N + n] : 0;
      }
    }
    ac::commit();
  };

  const int grp = threadIdx.x / kSmallTN;
  const int col = threadIdx.x % kSmallTN;
  int acc[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) acc[r] = 0;

  if (u0 < u1) stage(u0, 0);
  for (long long u = u0; u < u1; ++u) {
    const int buf = (int)((u - u0) & 1);
    if (u + 1 < u1) stage(u + 1, buf ^ 1);
    else ac::commit();
    ac::wait<1>();
    if (u == u0) ac::bar_wait(bar, 0);
    __syncthreads();
    const int32_t* Ar = As + buf * kSmallA;
    const uint8_t* Br = Bs + buf * kSmallB;
    const int k0 = (int)(u % sk.chunks) * kChunk;
    const int kb = grp * kKPerGroup;
    const int ke = min(kb + kKPerGroup, K - k0);
#pragma unroll 4
    for (int kk = kb; kk < ke; ++kk) {
      const int braw = Br[kk * kSmallTN + col];
      const int bv = BSIGNED ? (int)(int8_t)braw : braw;
      const int ib = (bv + offset) & 255;
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
        acc[r] += term<U16>(Ar[r * kChunk + kk], bv, ib, offset, D);
    }
    if (U16 && ke > kb) {   // this group's share of K * bias
#pragma unroll
      for (int r = 0; r < kRPT; ++r) acc[r] -= bias * (ke - kb);
    }
    if (u + 1 == u1 || (u + 1) % sk.chunks == 0) {
      // the end of this CTA's run of the tile: the groups' partials meet
      // in shared memory, one thread an output adds them into `out`
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        Red[(grp * kRPT + r) * kSmallTN + col] = acc[r];
        acc[r] = 0;
      }
      __syncthreads();
      const int m = grp;                      // kThreads / 128 == kRPT rows
      const int n = (int)(u / sk.chunks) * kSmallTN + col;
      int sum = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        sum += Red[(g * kRPT + m) * kSmallTN + col];
      if (m < M && n < N) atomicAdd(out + (size_t)m * N + n, sum);
    }
    __syncthreads();   // done with this unit's buffers and the partials
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <bool BSIGNED, bool U16>
cudaError_t launch_tiles(const int32_t* a, const uint8_t* b,
                         const int16_t* dlut, int32_t* out, int M, int K,
                         int N, int offset, int bias, cudaStream_t stream) {
  auto kern = tile_kernel<BSIGNED, U16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int tiles_n = (N + kTN - 1) / kTN;
  const int n_tiles = ((M + kTM - 1) / kTM) * tiles_n;
  const int grid = n_tiles < sms ? n_tiles : sms;
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  // K * bias modulo 2^32, as the int32 sums wrap
  const int kbias = (int)((unsigned)K * (unsigned)bias);
  kern<<<grid, kThreads, kTileSmem, stream>>>(a, b, dlut, out, M, K, N,
                                              offset, tiles_n, n_tiles, vec,
                                              kbias);
  return cudaGetLastError();
}

template <bool BSIGNED, bool U16>
cudaError_t launch_small_m(const int32_t* a, const uint8_t* b,
                           const int16_t* dlut, int32_t* out, int M, int K,
                           int N, int offset, int bias, cudaStream_t stream) {
  auto kern = small_m_kernel<BSIGNED, U16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmallSmem);
  if (err != cudaSuccess) return err;
  // the CTAs add their k-slice sums into out
  err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const ac::StreamK sk = ac::stream_k((N + kSmallTN - 1) / kSmallTN,
                                      (K + kChunk - 1) / kChunk, sms);
  const int avec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const int bvec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  kern<<<sk.grid, kThreads, kSmallSmem, stream>>>(a, b, dlut, out, M, K, N,
                                                  offset, sk, avec, bvec,
                                                  bias);
  return cudaGetLastError();
}

}  // namespace

// a (M,K) int32, b (K,N) uint8 (b_signed=0) or int8 viewed as bytes
// (b_signed=1), dlut (256,256) 16-bit entries (16-byte aligned): int16
// (u16=0, bias 0), or uint16 holding D + bias (u16=1, unsigned operands
// only; cudaErrorInvalidValue otherwise); out (M,N) int32.  All row-major
// and contiguous.  Returns the cudaError_t of the launch.
extern "C" int delta_matmul_launch(const void* a, const void* b,
                                   const void* dlut, void* out, int M, int K,
                                   int N, int offset, int b_signed, int u16,
                                   int bias, void* stream) {
  if (u16 ? b_signed != 0 : bias != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  auto O = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (K <= 0)
    return (int)cudaMemsetAsync(O, 0, (size_t)M * N * sizeof(int32_t), s);
  auto A = static_cast<const int32_t*>(a);
  auto Bp = static_cast<const uint8_t*>(b);
  auto Dp = static_cast<const int16_t*>(dlut);
  if (M <= 4) {
    if (b_signed)
      return launch_small_m<true, false>(A, Bp, Dp, O, M, K, N, offset, 0, s);
    return u16 ? launch_small_m<false, true>(A, Bp, Dp, O, M, K, N, offset,
                                             bias, s)
               : launch_small_m<false, false>(A, Bp, Dp, O, M, K, N, offset,
                                              0, s);
  }
  if (b_signed)
    return launch_tiles<true, false>(A, Bp, Dp, O, M, K, N, offset, 0, s);
  return u16 ? launch_tiles<false, true>(A, Bp, Dp, O, M, K, N, offset, bias,
                                         s)
             : launch_tiles<false, false>(A, Bp, Dp, O, M, K, N, offset, 0,
                                          s);
}
