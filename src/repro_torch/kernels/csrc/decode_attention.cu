// Fused decode-step attention for Hopper (sm_90a).
//
// For each batch slot b and kv head: qk-rmsnorm the group's query heads
// and the new key row, rope them at the slot's cache position pos[b],
// round the new k/v rows through bf16 (the cache dtype), then run masked
// single-query GQA attention over cache positions t <= pos[b] (and
// t > pos[b] - window with a window) with an online softmax, reading
// the rounded new row at t == pos[b].  Returns the output and the two
// bf16 rows; the wrapper appends the rows to the cache.
//
// Replaces the Pallas TPU kernel `decode_attention_step` of the JAX
// package (src/repro/kernels/attention.py, body `_decode_attn_kernel`).
// Its plain version is repro_torch.kernels.ref.decode_attention_step_ref.
//
// What bounds it on this card: the bytes of the cache rows it reads
// (2 * (pos+1) * hd bf16 values per slot and kv head); the arithmetic
// is a few flops per byte.  The design reads every cache row once for
// the whole query group of its kv head (head h reads kv head
// h / group), one CTA per (kv head, slot), four warps splitting the
// positions, each with its own online-softmax state, merged at the end.
// A lane holds the rope pairs (j, j + hd/2) for j = lane + 32*i, so rope
// needs no shuffles and any even head_dim up to 256 fits.
// Masked positions are skipped, which is exact: the reference's
// exp(-1e30 - m) is exactly 0 in f32.
//
// Where the numbers can go wrong:
//  * The new k/v rows are rounded through bf16 (round to nearest even)
//    and attention reads the rounded row, as the reference does.
//  * Built without fast math and with --fmad=false; the norm, rope and
//    score steps use _rn intrinsics in the reference's order.  Still,
//    the rmsnorm sum, the dot products and the softmax are float sums
//    in another order than torch's, and powf/cosf/sinf/rsqrtf may differ
//    from the plain version's by ulps, so the output agrees to a stated
//    tolerance and a bf16 row can, rarely, land one bf16 step away
//    (chip_smoke.py reports how many did).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A lane's share of one hd-vector: v[i] = x[j_i], v[PPL + i] = x[j_i + half]
// with j_i = lane + 32*i, valid while j_i < half (invalid slots hold 0).
template <int PPL>
struct Lanes {
  float v[2 * PPL];
  static __device__ __forceinline__ int elem(int s, int lane, int half) {
    return s < PPL ? lane + 32 * s : lane + 32 * (s - PPL) + half;
  }
  static __device__ __forceinline__ bool ok(int s, int lane, int half) {
    return lane + 32 * (s % PPL) < half;
  }
  __device__ __forceinline__ void load(const float* src, int lane, int half) {
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s)
      v[s] = ok(s, lane, half) ? src[elem(s, lane, half)] : 0.f;
  }
};

// rmsnorm (optional) + rope at `pos` of one vector held as Lanes.
template <int PPL>
__device__ void norm_rope(Lanes<PPL>& x, const float* gain, int qk_norm,
                          float theta, int pos, int lane, int half) {
  if (qk_norm) {
    float ss = 0.f;
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s) ss = __fadd_rn(ss, __fmul_rn(x.v[s], x.v[s]));
    ss = warp_sum(ss);
    const float var = __fdiv_rn(ss, (float)(2 * half));
    const float r = rsqrtf(__fadd_rn(var, 1e-6f));
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s)
      if (Lanes<PPL>::ok(s, lane, half))
        x.v[s] = __fmul_rn(__fmul_rn(x.v[s], r),
                           gain[Lanes<PPL>::elem(s, lane, half)]);
  }
  if (theta != 0.f) {
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int j = lane + 32 * i;
      if (j >= half) continue;
      const float freq = powf(theta, __fdiv_rn(-(float)j, (float)half));
      const float ang = __fmul_rn((float)pos, freq);
      const float c = cosf(ang), s = sinf(ang);
      const float x1 = x.v[i], x2 = x.v[PPL + i];
      x.v[i] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
      x.v[PPL + i] = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    }
  }
}

template <int PPL>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q, long long q_bs,
                        const float* __restrict__ kn, long long k_bs,
                        const float* __restrict__ vn, long long v_bs,
                        const float* __restrict__ q_gain,
                        const float* __restrict__ k_gain,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        const int32_t* __restrict__ pos, int pos_stride,
                        float* __restrict__ out, __nv_bfloat16* __restrict__ krow,
                        __nv_bfloat16* __restrict__ vrow, int H, int Kv,
                        int S, int hd, float theta, int window, int qk_norm,
                        float sqrt_hd) {
  using L = Lanes<PPL>;
  const int half = hd / 2;
  const int group = H / Kv;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos[(size_t)b * pos_stride];

  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [group][hd] normed, roped queries
  float* kr = qs + group * hd;           // [hd] new k row, bf16-rounded
  float* vr = kr + hd;                   // [hd] new v row, bf16-rounded
  float* wm = vr + hd;                   // [kWarps][group] running max
  float* wl = wm + kWarps * group;       // [kWarps][group] denominators
  float* wacc = wl + kWarps * group;     // [kWarps][group][hd] accumulators

  // 1. the query group and the new k row (norm + rope), the new v row
  for (int j = warp; j < group + 2; j += kWarps) {
    L x;
    if (j < group) x.load(q + (size_t)b * q_bs + (size_t)(kvh * group + j) * hd, lane, half);
    else if (j == group) x.load(kn + (size_t)b * k_bs + (size_t)kvh * hd, lane, half);
    else x.load(vn + (size_t)b * v_bs + (size_t)kvh * hd, lane, half);
    if (j <= group)
      norm_rope<PPL>(x, j < group ? q_gain : k_gain, qk_norm, theta, p, lane, half);
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s) {
      if (!L::ok(s, lane, half)) continue;
      const int d = L::elem(s, lane, half);
      if (j < group) {
        qs[j * hd + d] = x.v[s];
      } else {
        const __nv_bfloat16 h = __float2bfloat16_rn(x.v[s]);
        (j == group ? krow : vrow)[((size_t)b * Kv + kvh) * hd + d] = h;
        (j == group ? kr : vr)[d] = __bfloat162float(h);
      }
    }
  }
  __syncthreads();

  // 2. online softmax over this warp's share of the valid positions
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][2 * PPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s) acc[g][s] = 0.f;
  }
  const int t_hi = p < S - 1 ? p : S - 1;
  int t_lo = 0;
  if (window > 0 && p - window + 1 > 0) t_lo = p - window + 1;
  for (int t = t_lo + warp; t <= t_hi; t += kWarps) {
    L kv, vv;
    if (t == p) {
      kv.load(kr, lane, half);
      vv.load(vr, lane, half);
    } else {
      const size_t base = (((size_t)b * S + t) * Kv + kvh) * hd;
#pragma unroll
      for (int s = 0; s < 2 * PPL; ++s) {
        const bool ok = L::ok(s, lane, half);
        const int d = L::elem(s, lane, half);
        kv.v[s] = ok ? __bfloat162float(kc[base + d]) : 0.f;
        vv.v[s] = ok ? __bfloat162float(vc[base + d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
      float d = 0.f;
#pragma unroll
      for (int s = 0; s < 2 * PPL; ++s)
        if (L::ok(s, lane, half))
          d = __fadd_rn(d, __fmul_rn(qs[g * hd + L::elem(s, lane, half)], kv.v[s]));
      const float lg = __fdiv_rn(warp_sum(d), sqrt_hd);
      const float mn = fmaxf(m[g], lg);
      const float alpha = expf(__fsub_rn(m[g], mn));
      const float pe = expf(__fsub_rn(lg, mn));
      l[g] = __fadd_rn(__fmul_rn(l[g], alpha), pe);
#pragma unroll
      for (int s = 0; s < 2 * PPL; ++s)
        acc[g][s] = __fadd_rn(__fmul_rn(acc[g][s], alpha), __fmul_rn(pe, vv.v[s]));
      m[g] = mn;
    }
  }

  // 3. merge the warps' states and write out[b, h, :]
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    if (lane == 0) {
      wm[warp * group + g] = m[g];
      wl[warp * group + g] = l[g];
    }
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s)
      if (L::ok(s, lane, half))
        wacc[(warp * group + g) * hd + L::elem(s, lane, half)] = acc[g][s];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < group * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * group + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * group + g];
      if (mw == -INFINITY) continue;  // a warp that saw no position
      const float sc = expf(__fsub_rn(mw, mx));
      den = __fadd_rn(den, __fmul_rn(wl[w * group + g], sc));
      num = __fadd_rn(num, __fmul_rn(wacc[(w * group + g) * hd + d], sc));
    }
    out[((size_t)b * H + kvh * group + g) * hd + d] = __fdiv_rn(num, den);
  }
}

template <int PPL>
cudaError_t launch(const float* q, long long q_bs, const float* kn,
                   long long k_bs, const float* vn, long long v_bs,
                   const float* qg, const float* kg, const __nv_bfloat16* kc,
                   const __nv_bfloat16* vc, const int32_t* pos, int pos_stride,
                   float* out, __nv_bfloat16* krow, __nv_bfloat16* vrow,
                   int B, int H, int Kv, int S, int hd, float theta,
                   int window, int qk_norm, float sqrt_hd,
                   cudaStream_t stream) {
  const int group = H / Kv;
  const size_t smem =
      sizeof(float) * ((size_t)group * hd + 2 * hd + 2 * kWarps * group +
                       (size_t)kWarps * group * hd);
  auto kern = decode_attention_kernel<PPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Kv, B), kThreads, smem, stream>>>(
      q, q_bs, kn, k_bs, vn, v_bs, qg, kg, kc, vc, pos, pos_stride, out, krow,
      vrow, H, Kv, S, hd, theta, window, qk_norm, sqrt_hd);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,hd) f32 with batch stride q_bs (heads packed), kn/vn (B,Kv,hd)
// f32 with batch strides k_bs/v_bs; q_gain/k_gain (hd,) f32 (ignored
// unless qk_norm); k/v caches (B,S,Kv,hd) bf16 contiguous; pos int32,
// pos[b * pos_stride] (stride 0: one position for every slot); out
// (B,H,hd) f32; krow/vrow (B,Kv,hd) bf16.  window <= 0: no window.
// hd even and <= 256, H / Kv <= 8 (the wrapper checks).
// Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(
    const void* q, long long q_bs, const void* kn, long long k_bs,
    const void* vn, long long v_bs, const void* q_gain, const void* k_gain,
    const void* k_cache, const void* v_cache, const void* pos, int pos_stride,
    void* out, void* krow, void* vrow, int B, int H, int Kv, int S, int hd,
    float theta, int window, int qk_norm, void* stream) {
  if (B <= 0) return 0;
  if (hd <= 0 || hd % 2 || hd > 256 || Kv <= 0 || H % Kv || H / Kv > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  const float sqrt_hd = (float)sqrt((double)hd);
#define DA_LAUNCH(PPL)                                                        \
  return launch<PPL>(                                                         \
      static_cast<const float*>(q), q_bs, static_cast<const float*>(kn),     \
      k_bs, static_cast<const float*>(vn), v_bs,                             \
      static_cast<const float*>(q_gain), static_cast<const float*>(k_gain),  \
      static_cast<const __nv_bfloat16*>(k_cache),                            \
      static_cast<const __nv_bfloat16*>(v_cache),                            \
      static_cast<const int32_t*>(pos), pos_stride, static_cast<float*>(out), \
      static_cast<__nv_bfloat16*>(krow), static_cast<__nv_bfloat16*>(vrow),  \
      B, H, Kv, S, hd, theta, window, qk_norm, sqrt_hd,                      \
      static_cast<cudaStream_t>(stream))
  switch ((hd / 2 + 31) / 32) {
    case 1: DA_LAUNCH(1);
    case 2: DA_LAUNCH(2);
    case 3: DA_LAUNCH(3);
    default: DA_LAUNCH(4);
  }
#undef DA_LAUNCH
}
