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
// The design keeps the 128 KiB table in shared memory for a persistent
// CTA that walks output tiles, quantizes each activation tile as it is
// staged (x is read as f32 and never written back as integers), takes
// the per-row sums in the same pass, and applies the dequant epilogue
// to the accumulator in registers before the one store.
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
//    order.  rowsum(mu_r[qx+off]) is a float sum: one thread per row adds
//    in increasing k, which is deterministic but not torch's order, so
//    with compensation on the output agrees with the plain version to a
//    stated tolerance (see chip_smoke.py), not bit for bit.
//  * Overflow: |acc| <= 6144 * 255^2 + 6144 * 2^15 < 2^31 at the path's
//    largest K.
//  * Ragged edges are masked (k stops at K), so no K-padding correction.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kColThreads = 128;
constexpr int kGroups = kThreads / kColThreads;
constexpr int kTK = 32;
constexpr int kRPT = 4;
constexpr int kTableBytes = 256 * 256 * 2;

template <int GR>
struct Tile {
  static constexpr int TM = GR * kRPT;
  static constexpr int TN = kColThreads * (kGroups / GR);
  static constexpr int kSmem =
      kTableBytes + 256 * 4 + TM * kTK * 4 + kTK * TN + TM * 8;
};

template <int GR, bool ASYM, bool COMP>
__global__ void __launch_bounds__(kThreads)
fused_qdot_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qw,
                  const int16_t* __restrict__ dlut,
                  const float* __restrict__ scal,
                  const float* __restrict__ ntab,
                  const float* __restrict__ comp_r, float* __restrict__ out,
                  int32_t* __restrict__ qx_out, int32_t* __restrict__ acc_out,
                  int M, int K, int N, int tiles_n, int n_tiles, int b_vec16) {
  using T = Tile<GR>;
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* D = reinterpret_cast<int16_t*>(smem);
  float* MU = reinterpret_cast<float*>(smem + kTableBytes);          // [256]
  int32_t* As = reinterpret_cast<int32_t*>(MU + 256);                // [TM][kTK]
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + T::TM * kTK);        // [kTK][TN]
  int32_t* RS = reinterpret_cast<int32_t*>(Bs + kTK * T::TN);        // [TM]
  float* RC = reinterpret_cast<float*>(RS + T::TM);                  // [TM]

  constexpr int off = ASYM ? 0 : 128;
  constexpr float lo = ASYM ? 0.0f : -128.0f;
  constexpr float hi = ASYM ? 255.0f : 127.0f;
  const float sx = scal[0], zx = scal[1], mu = scal[2];
  const float kf = (float)K;

  {
    const int4* src = reinterpret_cast<const int4*>(dlut);
    int4* dst = reinterpret_cast<int4*>(D);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += kThreads)
      dst[i] = src[i];
    for (int i = threadIdx.x; i < 256; i += kThreads) MU[i] = comp_r[i];
  }

  const int grp = threadIdx.x / kColThreads;
  const int rg = grp % GR;
  const int col = (grp / GR) * kColThreads + threadIdx.x % kColThreads;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * T::TM;
    const int n0 = (tile % tiles_n) * T::TN;
    int acc[kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) acc[r] = 0;
    int rs = 0;      // rowsum(qx) of row m0 + threadIdx.x (threads < TM)
    float rc = 0.f;  // rowsum(mu_r[qx + off]) of the same row

    for (int k0 = 0; k0 < K; k0 += kTK) {
      __syncthreads();
      for (int i = threadIdx.x; i < T::TM * kTK; i += kThreads) {
        const int m = m0 + i / kTK, k = k0 + i % kTK;
        int q = 0;
        if (m < M && k < K) {
          float v = __fdiv_rn(x[(size_t)m * K + k], sx);
          v = __fadd_rn(rintf(v), zx);
          q = (int)fminf(fmaxf(v, lo), hi);
          if (qx_out != nullptr && n0 == 0) qx_out[(size_t)m * K + k] = q;
        }
        As[i] = q;
      }
      if (b_vec16) {
        for (int i = threadIdx.x; i < kTK * T::TN / 16; i += kThreads) {
          const int r = i / (T::TN / 16), c = (i % (T::TN / 16)) * 16;
          const int k = k0 + r, n = n0 + c;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k < K && n < N)
            v = *reinterpret_cast<const uint4*>(qw + (size_t)k * N + n);
          *reinterpret_cast<uint4*>(Bs + r * T::TN + c) = v;
        }
      } else {
        for (int i = threadIdx.x; i < kTK * T::TN; i += kThreads) {
          const int k = k0 + i / T::TN, n = n0 + i % T::TN;
          Bs[i] = (k < K && n < N) ? qw[(size_t)k * N + n] : 0;
        }
      }
      __syncthreads();
      const int kmax = min(kTK, K - k0);
      if (threadIdx.x < T::TM) {  // row sums, in increasing k
        for (int kk = 0; kk < kmax; ++kk) {
          const int q = As[threadIdx.x * kTK + kk];
          rs += q;
          if (COMP) rc = __fadd_rn(rc, MU[q + off]);
        }
      }
      for (int kk = 0; kk < kmax; ++kk) {
        const int braw = Bs[kk * T::TN + col];
        const int bv = ASYM ? braw : (int)(int8_t)braw;
        const int ib = bv + off;
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const int av = As[(rg * kRPT + r) * kTK + kk];
          acc[r] += av * bv + (int)D[((av + off) << 8) | ib];
        }
      }
    }
    if (threadIdx.x < T::TM) {
      RS[threadIdx.x] = rs;
      RC[threadIdx.x] = rc;
    }
    __syncthreads();

    const int n = n0 + col;
    if (n < N) {
      const float sw = ntab[n];
      const float zw = ntab[N + n];
      const float colsum = ntab[2 * N + n];
      const float ccol = ntab[3 * N + n];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        const int lr = rg * kRPT + r;
        const int m = m0 + lr;
        if (m >= M) continue;
        float accf = __int2float_rn(acc[r]);
        if (COMP) {
          const float c = __fsub_rn(__fadd_rn(RC[lr], ccol), __fmul_rn(kf, mu));
          accf = __fsub_rn(accf, c);
        }
        if (ASYM) {
          accf = __fsub_rn(accf, __fmul_rn(zw, __int2float_rn(RS[lr])));
          accf = __fsub_rn(accf, __fmul_rn(zx, colsum));
          accf = __fadd_rn(accf, __fmul_rn(__fmul_rn(kf, zx), zw));
        }
        out[(size_t)m * N + n] = __fmul_rn(accf, __fmul_rn(sx, sw));
        if (acc_out != nullptr) acc_out[(size_t)m * N + n] = acc[r];
      }
    }
  }
}

template <int GR, bool ASYM, bool COMP>
cudaError_t launch(const float* x, const uint8_t* qw, const int16_t* dlut,
                   const float* scal, const float* ntab, const float* comp_r,
                   float* out, int32_t* qx_out, int32_t* acc_out, int M,
                   int K, int N, cudaStream_t stream) {
  using T = Tile<GR>;
  auto kern = fused_qdot_kernel<GR, ASYM, COMP>;
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
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(qw) % 16 == 0);
  kern<<<grid, kThreads, T::kSmem, stream>>>(x, qw, dlut, scal, ntab, comp_r,
                                             out, qx_out, acc_out, M, K, N,
                                             tiles_n, n_tiles, vec);
  return cudaGetLastError();
}

template <int GR>
cudaError_t dispatch(int asym, int comp, const float* x, const uint8_t* qw,
                     const int16_t* dlut, const float* scal,
                     const float* ntab, const float* comp_r, float* out,
                     int32_t* qx_out, int32_t* acc_out, int M, int K, int N,
                     cudaStream_t s) {
  if (asym)
    return comp ? launch<GR, true, true>(x, qw, dlut, scal, ntab, comp_r, out,
                                         qx_out, acc_out, M, K, N, s)
                : launch<GR, true, false>(x, qw, dlut, scal, ntab, comp_r, out,
                                          qx_out, acc_out, M, K, N, s);
  return comp ? launch<GR, false, true>(x, qw, dlut, scal, ntab, comp_r, out,
                                        qx_out, acc_out, M, K, N, s)
              : launch<GR, false, false>(x, qw, dlut, scal, ntab, comp_r, out,
                                         qx_out, acc_out, M, K, N, s);
}

}  // namespace

// x (M,K) f32; qw (K,N) uint8 (asym) or int8 viewed as bytes (sym);
// dlut (256,256) int16; scal (8,) f32 [sx, zx, comp_mu, ...]; ntab (4,N)
// f32 rows [sw, zw, colsum, comp_col]; comp_r (256,) f32; out (M,N) f32.
// qx_out (M,K) and acc_out (M,N) int32 are optional (null to skip).
// All row-major and contiguous.  Returns the cudaError_t of the launch.
extern "C" int fused_qdot_launch(const void* x, const void* qw,
                                 const void* dlut, const void* scal,
                                 const void* ntab, const void* comp_r,
                                 void* out, void* qx_out, void* acc_out,
                                 int M, int K, int N, int asym, int compensate,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto X = static_cast<const float*>(x);
  auto Q = static_cast<const uint8_t*>(qw);
  auto Dp = static_cast<const int16_t*>(dlut);
  auto S = static_cast<const float*>(scal);
  auto NT = static_cast<const float*>(ntab);
  auto CR = static_cast<const float*>(comp_r);
  auto O = static_cast<float*>(out);
  auto QO = static_cast<int32_t*>(qx_out);
  auto AO = static_cast<int32_t*>(acc_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    return dispatch<1>(asym, compensate, X, Q, Dp, S, NT, CR, O, QO, AO, M, K,
                       N, s);
  return dispatch<4>(asym, compensate, X, Q, Dp, S, NT, CR, O, QO, AO, M, K, N,
                     s);
}
