// Fused quantize -> delta product -> dequant for Hopper (sm_90a).
//
//   qx  = clip(rint(x / sx) + zx, lo, hi)
//   acc = sum_k qx*qw + D[qx+off][qw+off]                     (int32)
//   y   = (acc - comp - zw*rowsum(qx) - zx*colsum + K*zx*zw) * sx*sw
//   comp = rowsum(mu_r[qx+off]) + comp_col - K*mu    (when compensating)
//
// Replaces the Pallas TPU kernel `fused_qdot` of the JAX package
// (src/repro/kernels/approx_matmul.py, body `_fused_qdot_kernel`).  Its
// plain version is repro_torch.kernels.ref.fused_qdot_ref.
//
// What bounds it on this card: as for delta_matmul.cu, the 16-bit
// gathers from the shared-memory delta table (one per (m, k, n) term).
// One call is two launches on the caller's stream:
//  1. quantize_rows: one CTA a row quantizes x once, into bytes (a
//     scratch of M rows padded to 16 bytes), and takes the row's two sums
//     in a fixed order; for the split-K schedule it also zeroes the
//     int32 accumulator and the tiles' arrival counts.
//  2. the gather, with the table in shared memory (one bulk copy on an
//     mbarrier per CTA, overlapping the first operand loads) and the
//     operand bytes staged 64 or 128 deep by cp.async into a double
//     buffer, the next step loading while the current one is gathered.
//     The gathers are gather_loop.cuh's loop; the exact part qx*qw is one
//     dp4a per 4 terms.  Two schedules, chosen by M alone:
//      * M > 8 (tile_kernel, prefill): a persistent grid of at most one
//        CTA per SM walks output tiles of 32 rows x 128 columns; each of
//        the 512 threads sums 8 rows of one column and applies the
//        dequant epilogue to its accumulators before the one store.
//      * M <= 8 (splitk_kernel, decode): N/128 tiles of one row group
//        would leave most of the 132 SMs idle (minitron-8b's w_down at M
//        = 8: 32 CTAs, 4 of each one's 16 warps gathering), so the
//        (128-column tile, k chunk) units are split evenly over one CTA
//        per SM (stream-K, async_copy.cuh), as delta_matmul does.  Each
//        of the CTA's 4 thread groups takes a quarter of a chunk's k for
//        the tile's 128 columns and R rows: R = 4 and 64-deep chunks at M
//        <= 4, R = 8 and 128-deep chunks at M 5-8, so each staged b byte
//        serves 8 gathers and a thread makes 256 gathers between two
//        __syncthreads.  At M = 8 minitron-8b's four merged projections
//        take 0.742 ms a layer on an H100 at 700 W against the tile
//        schedule's 1.966-1.980 (uniform random operands; 64-deep chunks
//        0.786-0.788, 256-deep 0.715).  Each CTA adds its int32 partials
//        into the accumulator with atomicAdd, then adds the number of
//        chunks it brought to the tile's arrival count; the CTA that
//        brings the last chunk runs the epilogue on the whole sum (the
//        threadfence reduction pattern).
//
// Where the numbers can go wrong, and what this file does about it:
//  * Rounding mode: CUDA's roundf rounds half away from zero, jnp.round
//    and torch.round half to even.  The quantizer uses rintf (half to
//    even), so activations on exact .5 boundaries quantize alike.
//  * FMA contraction and fast math: the file is built without
//    --use_fast_math and with --fmad=false, and the quantizer and the
//    epilogue spell every operation with a _rn intrinsic in the
//    reference's order (x/sx is an IEEE division), so qx and every
//    epilogue step round exactly as the plain version's separate ops.
//  * Float sums: the integer accumulator and rowsum(qx) are exact in any
//    order, atomics included.  rowsum(mu_r[qx+off]) is summed once per
//    row by the pre-pass in float64 (each thread in increasing k, then a
//    fixed shuffle tree and the warps in order) and rounded once to
//    float32, as the plain version sums it: the float64 sum of K float32
//    terms is within 1e-16 of exact, so both round to the same float32
//    (they could differ only where the exact sum lies within that of a
//    float32 rounding boundary).  A float32 sum in another order than
//    the plain version's was an ulp apart now and then, which the asym
//    epilogue's cancellation (acc and zx * colsum near 1e9 at K =
//    18,432) turned into output gaps past check.FUSED_ATOL_REL; the
//    compensated output now agrees with the plain version bit for bit,
//    as the uncompensated one always did.
//  * Overflow: the int32 sums wrap modulo 2^32 where they pass 2^31
//    (255^2 * K does from K = 33,026: nemotron-4-340b's w_down has K =
//    73,728), as the reference's int32 accumulation does; the plain
//    version wraps alike.
//  * A biased table (U16, asym_u8 only: the unsigned 'initial', whose D in
//    [-48744, 0] needs 17 bits as int16) holds T = D + bias as uint16
//    (ops.narrow_delta).  The sums of T are exact modulo 2^32, and the
//    epilogue subtracts K * bias (modulo 2^32) once from each output, on
//    both schedules, before acc_out and the dequant see it.
//  * Ragged edges are masked (k stops at K), so no K-padding correction.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "gather_loop.cuh"

namespace {

namespace ac = async_copy;
namespace gl = gather_loop;

constexpr int kThreads = 512;
constexpr int kCols = 128;                  // threads along n (= TN)
constexpr int kGroups = kThreads / kCols;
constexpr int kTK = 64;                     // k depth of a staged step
constexpr int kTN = kCols;
constexpr int kStageB = kTK * kTN;
static_assert(kStageB / 16 == kThreads, "one 16-byte b copy a thread");

// tile_kernel: 4 row groups x 8 rows
constexpr int kRPT = 8;
constexpr int kTM = kGroups * kRPT;         // 32
constexpr int kStageA = kTM * kTK;
constexpr int kTileSmem = gl::kTableBytes + 2 * kStageA + 2 * kStageB + 16;

// splitk_kernel: M <= kSplitMaxRows takes the split-K schedule, with R =
// kSmallR rows for M <= 4 and R = kSplitMaxRows for 5 <= M <= 8.  A unit is
// one 128-column tile's UK-deep k chunk; thread group g takes k
// [g UK/4, (g + 1) UK/4) of it for the tile's 128 columns and R rows.
constexpr int kSmallR = 4;
constexpr int kSplitMaxRows = 8;            // ops.FUSED_SPLIT_MAX_ROWS
constexpr int kSplitDepth4 = 64;            // UK at R = 4
constexpr int kSplitDepth8 = 128;           // UK at R = 8

template <int R, int UK>
struct Split {
  static_assert(R % kGroups == 0, "R / kGroups outputs a reducing thread");
  static_assert(UK % kTK == 0, "a unit is whole 64-deep b stages");
  static constexpr int kA = R * UK;         // a bytes of a unit
  static constexpr int kB = UK * kTN;       // b bytes of a unit
  static constexpr int kKPerGroup = UK / kGroups;
  // table, a and b double buffers, the groups' partials, a flag, mbarrier
  static constexpr int kSmem = gl::kTableBytes + 2 * kA + 2 * kB
      + kGroups * R * kTN * 4 + 16 + 16;
  static_assert(kSmem <= 232448, "over a block's shared memory opt-in");
};

constexpr int kQThreads = 256;              // quantize_rows

// The schedule M takes: the split-K schedule's rows a thread (kSmallR or
// kSplitMaxRows), or 0 for the tile schedule.
inline int split_rows(int M) {
  return M <= kSmallR ? kSmallR : M <= kSplitMaxRows ? kSplitMaxRows : 0;
}

// Byte layout of the caller's scratch (ops.fused_scratch_layout mirrors
// it): qx bytes (M rows of kp), rowsum(qx) int32 (M), rowsum(mu_r) f32
// (M); for M <= kSplitMaxRows also the int32 accumulator (M, N) and the
// tiles' arrival counts.  Each part starts 16-byte aligned.
struct Layout {
  long long kp, rs, rc, acc, cnt, bytes;
  bool splitk;
};

__host__ __device__ inline long long up16(long long v) {
  return (v + 15) / 16 * 16;
}

inline Layout layout(int M, int K, int N) {
  Layout L;
  L.kp = K > 16 ? up16(K) : 16;
  L.splitk = split_rows(M) > 0;
  L.rs = up16((long long)M * L.kp);
  L.rc = up16(L.rs + 4LL * M);
  L.acc = up16(L.rc + 4LL * M);
  L.cnt = up16(L.acc + 4LL * M * N);
  L.bytes = L.splitk ? L.cnt + 4LL * ((N + kTN - 1) / kTN) : L.acc;
  return L;
}

template <bool ASYM, bool COMP>
__global__ void __launch_bounds__(kQThreads)
quantize_rows(const float* __restrict__ x, const float* __restrict__ scal,
              const float* __restrict__ comp_r, uint8_t* __restrict__ qb,
              int32_t* __restrict__ qx_out, int32_t* __restrict__ rsum,
              float* __restrict__ rcomp, int32_t* __restrict__ zero,
              long long nzero, int K, int kp) {
  __shared__ float MU[256];
  __shared__ int wrs[kQThreads / 32];
  __shared__ double wrc[kQThreads / 32];
  constexpr int off = ASYM ? 0 : 128;
  constexpr float lo = ASYM ? 0.0f : -128.0f;
  constexpr float hi = ASYM ? 255.0f : 127.0f;
  const int tid = threadIdx.x, m = blockIdx.x;
  for (long long i = (long long)m * kQThreads + tid; i < nzero;
       i += (long long)gridDim.x * kQThreads)
    zero[i] = 0;
  if (COMP)
    for (int i = tid; i < 256; i += kQThreads) MU[i] = comp_r[i];
  __syncthreads();
  const float sx = scal[0], zx = scal[1];
  int rs = 0;
  double rc = 0.0;
  for (int k = tid; k < kp; k += kQThreads) {
    int q = 0;
    if (k < K) {
      float v = __fdiv_rn(x[(size_t)m * K + k], sx);
      v = __fadd_rn(rintf(v), zx);
      q = (int)fminf(fmaxf(v, lo), hi);
      if (qx_out != nullptr) qx_out[(size_t)m * K + k] = q;
      rs += q;
      if (COMP) rc = __dadd_rn(rc, (double)MU[q + off]);
    }
    qb[(size_t)m * kp + k] = (uint8_t)(q & 255);
  }
  for (int o = 16; o > 0; o >>= 1) {
    rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (COMP) rc = __dadd_rn(rc, __shfl_xor_sync(0xffffffffu, rc, o));
  }
  if (tid % 32 == 0) {
    wrs[tid / 32] = rs;
    wrc[tid / 32] = rc;
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    double c = 0.0;
    for (int w = 0; w < kQThreads / 32; ++w) {
      s += wrs[w];
      if (COMP) c = __dadd_rn(c, wrc[w]);
    }
    rsum[m] = s;
    rcomp[m] = __double2float_rn(c);
  }
}

// The dequant epilogue of one output, in the reference's order.
template <bool ASYM, bool COMP>
__device__ __forceinline__ float dequant(int acc, int rs, float rc,
                                         const float* scal,
                                         const float* ntab, int n, int N,
                                         float kf) {
  const float sx = scal[0], zx = scal[1], mu = scal[2];
  const float sw = ntab[n];
  float accf = __int2float_rn(acc);
  if (COMP) {
    const float c = __fsub_rn(__fadd_rn(rc, ntab[3 * N + n]),
                              __fmul_rn(kf, mu));
    accf = __fsub_rn(accf, c);
  }
  if (ASYM) {
    const float zw = ntab[N + n];
    accf = __fsub_rn(accf, __fmul_rn(zw, __int2float_rn(rs)));
    accf = __fsub_rn(accf, __fmul_rn(zx, ntab[2 * N + n]));
    accf = __fadd_rn(accf, __fmul_rn(__fmul_rn(kf, zx), zw));
  }
  return __fmul_rn(accf, __fmul_rn(sx, sw));
}

struct Args {
  const float* x;
  const uint8_t* qw;
  const int16_t* dlut;
  const float* scal;
  const float* ntab;
  const float* comp_r;
  float* out;
  int32_t* qx_out;
  int32_t* acc_out;
  uint8_t* qb;
  int32_t* rsum;
  float* rcomp;
  int32_t* acc;
  int32_t* cnt;
  int M, K, kp, N, b_vec16;
  int kbias;               // K * bias of a biased table (U16), else 0
};

// b of the step at (k0, n0) into Bd: one 16-byte cp.async a thread
__device__ __forceinline__ void stage_b(const Args& g, uint8_t* Bd, int k0,
                                        int n0) {
  const int tid = threadIdx.x;
  if (g.b_vec16) {  // N % 16 == 0 and qw 16-byte aligned
    const int r = tid / (kTN / 16), c = (tid % (kTN / 16)) * 16;
    const int k = k0 + r, n = n0 + c;
    const bool in = k < g.K && n < g.N;
    ac::cp16(Bd + r * kTN + c, in ? g.qw + (size_t)k * g.N + n : g.qw, in);
  } else {
    for (int i = tid; i < kStageB; i += kThreads) {
      const int k = k0 + i / kTN, n = n0 + i % kTN;
      Bd[i] = (k < g.K && n < g.N) ? g.qw[(size_t)k * g.N + n] : 0;
    }
  }
}

// rows x depth a bytes of the step at (m0, k0) into Ad (row pitch depth,
// a multiple of 16); the scratch rows are kp bytes, a multiple of 16
// padded with zeros
__device__ __forceinline__ void stage_a(const Args& g, uint8_t* Ad, int rows,
                                        int depth, int m0, int k0) {
  const int tid = threadIdx.x;
  if (tid < rows * (depth / 16)) {
    const int r = tid / (depth / 16), c = (tid % (depth / 16)) * 16;
    const int m = m0 + r, k = k0 + c;
    const bool in = m < g.M && k < g.kp;
    ac::cp16(Ad + r * depth + c, in ? g.qb + (size_t)m * g.kp + k : g.qb, in);
  }
}

template <bool ASYM, bool COMP, bool U16>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(const Args g, int tiles_n, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* As = smem + gl::kTableBytes;           // [2][kTM][kTK]
  uint8_t* Bs = As + 2 * kStageA;                 // [2][kTK][kTN]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + 2 * kStageB);
  const uint32_t tab = ac::smem_addr(smem);
  constexpr int off = ASYM ? 0 : 128;
  constexpr int kExact = ASYM ? 1 : 2;
  constexpr uint32_t axor = ASYM ? 0u : 0x80808080u;

  const int tid = threadIdx.x;
  const int rg = tid / kCols, col = tid % kCols;
  const int K = g.K;
  const int stages = K > 0 ? (K + kTK - 1) / kTK : 1;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = my_tiles * stages;

  if (tid == 0) ac::bar_init(bar);
  __syncthreads();
  if (tid == 0) ac::bulk_load(smem, g.dlut, gl::kTableBytes, bar);

  auto origin = [&](int s, int& m0, int& n0, int& k0) {
    const int tile = blockIdx.x + (s / stages) * gridDim.x;
    m0 = (tile / tiles_n) * kTM;
    n0 = (tile % tiles_n) * kTN;
    k0 = (s % stages) * kTK;
  };
  auto stage = [&](int s, int buf) {
    int m0, n0, k0;
    origin(s, m0, n0, k0);
    stage_a(g, As + buf * kStageA, kTM, kTK, m0, k0);
    stage_b(g, Bs + buf * kStageB, k0, n0);
    ac::commit();
  };

  int acc[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) acc[r] = 0;
  const float kf = (float)K;

  stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) stage(s + 1, buf ^ 1);
    else ac::commit();
    ac::wait<1>();
    if (s == 0) ac::bar_wait(bar, 0);
    __syncthreads();               // step s's a and b are in
    int m0, n0, k0;
    origin(s, m0, n0, k0);
    if (m0 + rg * kRPT < g.M)      // warp-uniform: rows of this group
      gl::gather_run<kRPT, U16, kExact>(
          tab, As + buf * kStageA + rg * kRPT * kTK, kTK,
          Bs + buf * kStageB + col, kTN, min(kTK, K - k0), axor, off, acc);
    if (s % stages == stages - 1) {
      const int n = n0 + col;
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        const int m = m0 + rg * kRPT + r;
        if (m < g.M && n < g.N) {
          const int v = acc[r] - g.kbias;
          g.out[(size_t)m * g.N + n] = dequant<ASYM, COMP>(
              v, g.rsum[m], g.rcomp[m], g.scal, g.ntab, n, g.N, kf);
          if (g.acc_out != nullptr) g.acc_out[(size_t)m * g.N + n] = v;
        }
        acc[r] = 0;
      }
    }
    __syncthreads();               // done with buffer buf
  }
}

template <int R, int UK, bool ASYM, bool COMP, bool U16>
__global__ void __launch_bounds__(kThreads, 1)
splitk_kernel(const Args g, ac::StreamK sk) {
  using S = Split<R, UK>;
  constexpr int kOuts = R / kGroups;              // outputs a thread adds
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* As = smem + gl::kTableBytes;           // [2][R][UK]
  uint8_t* Bs = As + 2 * S::kA;                   // [2][UK][kTN]
  int32_t* Red = reinterpret_cast<int32_t*>(Bs + 2 * S::kB);
  int* last = reinterpret_cast<int*>(Red + kGroups * R * kTN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(last + 4);
  const uint32_t tab = ac::smem_addr(smem);
  constexpr int off = ASYM ? 0 : 128;
  constexpr int kExact = ASYM ? 1 : 2;
  constexpr uint32_t axor = ASYM ? 0u : 0x80808080u;

  const int tid = threadIdx.x;
  const int grp = tid / kTN, col = tid % kTN;
  const long long u0 = sk.begin(blockIdx.x), u1 = sk.begin(blockIdx.x + 1);
  if (tid == 0) ac::bar_init(bar);
  __syncthreads();
  if (tid == 0) ac::bulk_load(smem, g.dlut, gl::kTableBytes, bar);

  auto stage = [&](long long u, int buf) {
    const int n0 = (int)(u / sk.chunks) * kTN;
    const int k0 = (int)(u % sk.chunks) * UK;
    stage_a(g, As + buf * S::kA, R, UK, 0, k0);
#pragma unroll
    for (int j = 0; j < UK / kTK; ++j)
      stage_b(g, Bs + buf * S::kB + j * kStageB, k0 + j * kTK, n0);
    ac::commit();
  };

  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
  const float kf = (float)g.K;

  if (u0 < u1) stage(u0, 0);
  for (long long u = u0; u < u1; ++u) {
    const int buf = (int)((u - u0) & 1);
    if (u + 1 < u1) stage(u + 1, buf ^ 1);
    else ac::commit();
    ac::wait<1>();
    if (u == u0) ac::bar_wait(bar, 0);
    __syncthreads();
    const int tile = (int)(u / sk.chunks);
    const int k0 = (int)(u % sk.chunks) * UK;
    const int kb = grp * S::kKPerGroup;
    const int kn = min(S::kKPerGroup, g.K - k0 - kb);
    if (kn > 0)
      gl::gather_run<R, U16, kExact>(
          tab, As + buf * S::kA + kb, UK,
          Bs + buf * S::kB + kb * kTN + col, kTN, kn, axor, off, acc);
    if (u + 1 == u1 || (u + 1) % sk.chunks == 0) {
      // the end of this CTA's run of the tile: the groups' partials meet
      // in shared memory, and each thread adds kOuts outputs (rows grp,
      // grp + kGroups, ...) into the accumulator
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Red[(grp * R + r) * kTN + col] = acc[r];
        acc[r] = 0;
      }
      __syncthreads();
      const int n = tile * kTN + col;
      bool mine[kOuts];
#pragma unroll
      for (int j = 0; j < kOuts; ++j) {
        const int m = grp + j * kGroups;
        mine[j] = m < g.M && n < g.N;
        if (mine[j]) {
          int sum = 0;
#pragma unroll
          for (int q = 0; q < kGroups; ++q)
            sum += Red[(q * R + m) * kTN + col];
          atomicAdd(g.acc + (size_t)m * g.N + n, sum);
        }
      }
      __threadfence();                       // the adds before the count
      __syncthreads();
      if (tid == 0) {
        const long long first = (long long)tile * sk.chunks;
        const int brought = (int)(u + 1 - (u0 > first ? u0 : first));
        *last = atomicAdd(g.cnt + tile, brought) + brought == sk.chunks;
      }
      __syncthreads();
      if (*last) {                           // every chunk is in: epilogue
        __threadfence();
#pragma unroll
        for (int j = 0; j < kOuts; ++j) {
          const int m = grp + j * kGroups;
          if (mine[j]) {
            const size_t i = (size_t)m * g.N + n;
            const int v =
                *reinterpret_cast<volatile int32_t*>(g.acc + i) - g.kbias;
            g.out[i] = dequant<ASYM, COMP>(v, g.rsum[m], g.rcomp[m],
                                           g.scal, g.ntab, n, g.N, kf);
            if (g.acc_out != nullptr) g.acc_out[i] = v;
          }
        }
      }
    }
    __syncthreads();   // done with this unit's buffers, the partials, *last
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int R, int UK, bool ASYM, bool COMP, bool U16>
cudaError_t launch_split(const Args& g, int tiles_n, int sms,
                         cudaStream_t stream) {
  auto kern = splitk_kernel<R, UK, ASYM, COMP, U16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Split<R, UK>::kSmem);
  if (err != cudaSuccess) return err;
  const ac::StreamK sk = ac::stream_k(
      tiles_n, g.K > 0 ? (g.K + UK - 1) / UK : 1, sms);
  kern<<<sk.grid, kThreads, Split<R, UK>::kSmem, stream>>>(g, sk);
  return cudaSuccess;
}

template <bool ASYM, bool COMP, bool U16>
cudaError_t run(const Args& g, long long nzero, int rows,
                cudaStream_t stream) {
  quantize_rows<ASYM, COMP><<<g.M, kQThreads, 0, stream>>>(
      g.x, g.scal, g.comp_r, g.qb, g.qx_out, g.rsum, g.rcomp, g.acc, nzero,
      g.K, g.kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int tiles_n = (g.N + kTN - 1) / kTN;
  if (rows == kSmallR) {
    err = launch_split<kSmallR, kSplitDepth4, ASYM, COMP, U16>(
        g, tiles_n, sms, stream);
  } else if (rows == kSplitMaxRows) {
    err = launch_split<kSplitMaxRows, kSplitDepth8, ASYM, COMP, U16>(
        g, tiles_n, sms, stream);
  } else {
    auto kern = tile_kernel<ASYM, COMP, U16>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (err != cudaSuccess) return err;
    const int n_tiles = ((g.M + kTM - 1) / kTM) * tiles_n;
    kern<<<n_tiles < sms ? n_tiles : sms, kThreads, kTileSmem, stream>>>(
        g, tiles_n, n_tiles);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x (M,K) f32; qw (K,N) uint8 (asym) or int8 viewed as bytes (sym);
// dlut (256,256) 16-bit entries, 16-byte aligned: int16 (u16=0, bias 0)
// or uint16 holding D + bias (u16=1, asym only; cudaErrorInvalidValue
// otherwise); scal (8,) f32 [sx, zx, comp_mu,
// ...]; ntab (4,N) f32 rows [sw, zw, colsum, comp_col]; comp_r (256,)
// f32; out (M,N) f32.  qx_out (M,K) and acc_out (M,N) int32 are optional
// (null to skip).  scratch: scratch_bytes of device memory, 16-byte
// aligned, at least ops.fused_scratch_layout(M, K, N)["bytes"]; refused
// (cudaErrorInvalidValue) when smaller.  All row-major and contiguous.
// rows_out (optional int) receives the schedule launched: the split-K
// schedule's rows a thread (4 or 8), 0 for the tile schedule.  Returns
// the cudaError_t of the launches.
extern "C" int fused_qdot_launch(const void* x, const void* qw,
                                 const void* dlut, const void* scal,
                                 const void* ntab, const void* comp_r,
                                 void* out, void* qx_out, void* acc_out,
                                 void* scratch, long long scratch_bytes,
                                 int M, int K, int N, int asym, int compensate,
                                 int u16, int bias, int* rows_out,
                                 void* stream) {
  if (u16 ? !asym : bias != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  const int rows = split_rows(M);
  const Layout L = layout(M, K, N);
  if (scratch_bytes < L.bytes) return (int)cudaErrorInvalidValue;
  auto base = static_cast<uint8_t*>(scratch);
  Args g;
  g.x = static_cast<const float*>(x);
  g.qw = static_cast<const uint8_t*>(qw);
  g.dlut = static_cast<const int16_t*>(dlut);
  g.scal = static_cast<const float*>(scal);
  g.ntab = static_cast<const float*>(ntab);
  g.comp_r = static_cast<const float*>(comp_r);
  g.out = static_cast<float*>(out);
  g.qx_out = static_cast<int32_t*>(qx_out);
  g.acc_out = static_cast<int32_t*>(acc_out);
  g.qb = base;
  g.rsum = reinterpret_cast<int32_t*>(base + L.rs);
  g.rcomp = reinterpret_cast<float*>(base + L.rc);
  g.acc = L.splitk ? reinterpret_cast<int32_t*>(base + L.acc) : nullptr;
  g.cnt = L.splitk ? reinterpret_cast<int32_t*>(base + L.cnt) : nullptr;
  g.M = M;
  g.K = K;
  g.kp = (int)L.kp;
  g.N = N;
  g.b_vec16 = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(qw) % 16 == 0);
  // K * bias modulo 2^32, as the int32 sums wrap
  g.kbias = (int)((unsigned)(K > 0 ? K : 0) * (unsigned)bias);
  // the split-K accumulator and the arrival counts are contiguous
  const long long nzero = L.splitk ? (L.bytes - L.acc) / 4 : 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (asym && u16)
    err = compensate ? run<true, true, true>(g, nzero, rows, s)
                     : run<true, false, true>(g, nzero, rows, s);
  else if (asym)
    err = compensate ? run<true, true, false>(g, nzero, rows, s)
                     : run<true, false, false>(g, nzero, rows, s);
  else
    err = compensate ? run<false, true, false>(g, nzero, rows, s)
                     : run<false, false, false>(g, nzero, rows, s);
  if (err == cudaSuccess && rows_out != nullptr) *rows_out = rows;
  return (int)err;
}
