// Exact matmul + rank-r error correction for Hopper (sm_90a).
//
//   S[m,n] = float( sum_k a[m,k]*b[k,n] )
//            + sum_k sum_j F[(a[m,k]+off)&255][j] * G[j][(b[k,n]+off)&255]
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
// What bounds it on this card: float32 arithmetic.  The correction is a
// product of an (M, K*r) matrix of gathered F rows by a (K*r, N) matrix
// of gathered G columns, 2*M*K*N*r flops, r times the exact part's
// integer work, all on the 67 TFLOP/s float32 pipes (the reference kept
// it in f32 at HIGHEST precision; TF32 tensor cores would lose the
// correction's low bits).  The design is a register-tiled SIMT GEMM over
// that (K*r) inner dimension whose operand tiles are gathered while they
// are staged: each stage takes 32 (k, j) pairs, writes the gathered F
// values (64 rows) and G values (64 columns) to shared memory, and every
// thread then does 4 x 4 FMAs per pair from two 16-byte loads.  F and G
// themselves sit in shared memory when r <= 32 (64 KiB); above that they
// are read through the read-only cache (__ldg), 2 x 256 KiB at r = 256.
//
// The exact part is accumulated in int32 in the kernel's own loop (exact,
// K * 255^2 < 2^31 for K <= 33025) and converted once, so it equals the
// plain version's exact integer product converted to float32; only the
// correction's float32 sum order differs from the plain version.  Ragged
// edges are masked (zero-filled tiles add nothing).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kBI = 32;         // (k, j) pairs of the correction per stage
constexpr int kTK = 32;         // k depth per stage of the exact part
constexpr int kSmemRank = 32;   // F and G in shared memory up to this rank
constexpr int kTileBytes = (kBI * kTM + kBI * kTN) * 4;

template <bool BSIGNED>
__device__ __forceinline__ int bval(const uint8_t* b, size_t i) {
  return BSIGNED ? (int)(int8_t)b[i] : (int)b[i];
}

template <bool SMEM_FG, bool BSIGNED>
__global__ void __launch_bounds__(kThreads)
residual_matmul_kernel(const int32_t* __restrict__ a,
                       const uint8_t* __restrict__ b,
                       const float* __restrict__ F,
                       const float* __restrict__ G,
                       float* __restrict__ out, int M, int K, int N, int r,
                       int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);   // [kBI][kTM] gathered F
  float* Bs = As + kBI * kTM;                   // [kBI][kTN] gathered G
  __shared__ int pair_k[kBI], pair_j[kBI];
  const float* Fp = F;
  const float* Gp = G;
  if constexpr (SMEM_FG) {  // the factors, once per CTA
    float* Fs = Bs + kBI * kTN;                 // [256][r]
    float* Gs = Fs + 256 * r;                   // [r][256]
    for (int i = threadIdx.x; i < 256 * r; i += kThreads) {
      Fs[i] = F[i];
      Gs[i] = G[i];
    }
    Fp = Fs;
    Gp = Gs;
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;

  // 1. the exact product, int32, in the same tile memory
  int iacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) iacc[i][j] = 0;
  int32_t* Ai = reinterpret_cast<int32_t*>(As);  // [kTM][kTK]
  int32_t* Bi = reinterpret_cast<int32_t*>(Bs);  // [kTK][kTN]
  for (int k0 = 0; k0 < K; k0 += kTK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
      const int m = m0 + i / kTK, k = k0 + i % kTK;
      Ai[i] = (m < M && k < K) ? a[(size_t)m * K + k] : 0;
    }
    for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
      const int k = k0 + i / kTN, n = n0 + i % kTN;
      Bi[i] = (k < K && n < N) ? bval<BSIGNED>(b, (size_t)k * N + n) : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTK; ++kk) {
      const int4 bv = *reinterpret_cast<const int4*>(Bi + kk * kTN + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int av = Ai[(ty * 4 + i) * kTK + kk];
        iacc[i][0] += av * bv.x;
        iacc[i][1] += av * bv.y;
        iacc[i][2] += av * bv.z;
        iacc[i][3] += av * bv.w;
      }
    }
  }

  // 2. the rank-r correction over the flattened (k, j) pairs, float32
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int pairs = K * r;
  for (int t0 = 0; t0 < pairs; t0 += kBI) {
    __syncthreads();  // the previous stage's tiles are done
    if (threadIdx.x < kBI) {
      const int t = t0 + threadIdx.x;
      pair_k[threadIdx.x] = t < pairs ? t / r : -1;
      pair_j[threadIdx.x] = t < pairs ? t % r : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBI * kTM; i += kThreads) {
      const int t = i / kTM, m = m0 + i % kTM, k = pair_k[t];
      float v = 0.f;
      if (k >= 0 && m < M) {
        const int ia = (a[(size_t)m * K + k] + offset) & 255;
        if constexpr (SMEM_FG) v = Fp[ia * r + pair_j[t]];
        else v = __ldg(Fp + ia * r + pair_j[t]);
      }
      As[i] = v;
    }
    for (int i = threadIdx.x; i < kBI * kTN; i += kThreads) {
      const int t = i / kTN, n = n0 + i % kTN, k = pair_k[t];
      float v = 0.f;
      if (k >= 0 && n < N) {
        const int ib = (bval<BSIGNED>(b, (size_t)k * N + n) + offset) & 255;
        if constexpr (SMEM_FG) v = Gp[pair_j[t] * 256 + ib];
        else v = __ldg(Gp + pair_j[t] * 256 + ib);
      }
      Bs[i] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBI; ++t) {
      const float4 av = *reinterpret_cast<const float4*>(As + t * kTM + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + t * kTN + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = __fmaf_rn(ar[i], bv.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(ar[i], bv.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(ar[i], bv.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(ar[i], bv.w, acc[i][3]);
      }
    }
  }

  // 3. out = float(exact) + correction, as the plain version
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N)
        out[(size_t)m * N + n] = __fadd_rn((float)iacc[i][j], acc[i][j]);
    }
  }
}

template <bool SMEM_FG, bool BSIGNED>
cudaError_t launch(const int32_t* a, const uint8_t* b, const float* F,
                   const float* G, float* out, int M, int K, int N, int r,
                   int offset, cudaStream_t stream) {
  auto kern = residual_matmul_kernel<SMEM_FG, BSIGNED>;
  const int smem = kTileBytes + (SMEM_FG ? 2 * 256 * r * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  kern<<<grid, kThreads, smem, stream>>>(a, b, F, G, out, M, K, N, r,
                                         offset);
  return cudaGetLastError();
}

}  // namespace

// a (M,K) int32, b (K,N) uint8 (b_signed=0) or int8 viewed as bytes
// (b_signed=1), F (256,r) and G (r,256) float32 with 1 <= r <= 256,
// out (M,N) float32.  All row-major and contiguous; offset 0 or 128.
// Returns the cudaError_t of the launch.
extern "C" int residual_matmul_launch(const void* a, const void* b,
                                      const void* F, const void* G,
                                      void* out, int M, int K, int N, int r,
                                      int offset, int b_signed,
                                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (r < 1 || r > 256) return (int)cudaErrorInvalidValue;
  auto A = static_cast<const int32_t*>(a);
  auto Bp = static_cast<const uint8_t*>(b);
  auto Fp = static_cast<const float*>(F);
  auto Gp = static_cast<const float*>(G);
  auto O = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (r <= kSmemRank)
    return b_signed
        ? launch<true, true>(A, Bp, Fp, Gp, O, M, K, N, r, offset, s)
        : launch<true, false>(A, Bp, Fp, Gp, O, M, K, N, r, offset, s);
  return b_signed
      ? launch<false, true>(A, Bp, Fp, Gp, O, M, K, N, r, offset, s)
      : launch<false, false>(A, Bp, Fp, Gp, O, M, K, N, r, offset, s);
}
