// Fused decode-step attention for Hopper (sm_90a), split over the cache
// positions.
//
// For each batch slot b and kv head: qk-rmsnorm the group's query heads
// and the new key row, rope them at the slot's cache position pos[b],
// round the new k/v rows through bf16 (the cache dtype), then run masked
// single-query GQA attention over cache positions t <= pos[b] (and
// t > pos[b] - window with a window), reading the rounded new row at
// t == pos[b].  With `append` the kernel also writes the two rows into
// the caches at pos[b] (the serving path); without it into the row
// outputs, and the caches are only read.
//
// Replaces the Pallas TPU kernel `decode_attention_step` of the JAX
// package (src/repro/kernels/attention.py, body `_decode_attn_kernel`).
// Its plain version is repro_torch.kernels.ref.decode_attention_step_ref.
//
// What bounds it.  At long context, bytes: the cache rows t <= pos, read
// once (67 MB for 4 slots at pos 4095 of qwen3-1.7b's 8 kv heads).  On
// the serving path (73 of 80 positions, 1.2 MB) launch and latency: a
// chain of dependent steps (the position, the loads, norm and rope, the
// softmax, the merge) with little work in each.  What the design does:
//  * Split.  The grid is (chunk, kv head, slot).  The wrapper splits the
//    S_max positions into at most 16 chunks (ops.attention_chunks: 5
//    chunks of 16 at S_max = 80, 12 of 342 at 4096, qwen3-1.7b at B=4),
//    so that the blocks fill the SMs in one wave.  A chunk is read in
//    tiles of up to 32 KiB of K and V rows (ops.attention_tile_rows, also
//    the wrapper's: 64 rows at hd = 128), staged
//    by cp.async, 16 bytes a copy (4 where hd % 8 != 0).  K of the next
//    tile lands during this tile's P.V, V during the next scores.
//  * Two passes a tile, no rescale per position: the scores of every row
//    for all heads of the group first (a row's dot products over a power
//    of two of lanes, queries in registers, one shuffle tree), one
//    max/exp/sum pass per head, then P.V with a thread per (head, pair of
//    dims).  Across tiles the running max rescales once per tile.
//  * Latency.  The first tile is staged before pos[b] is known, together
//    with the queries, gains and rope frequencies (read through the
//    read-only path: every block of a (kv head, slot) reads the same
//    ones).  Row pos[b] among it is stale and replaced by the row this
//    kernel makes.  The frequencies come from the wrapper, computed on
//    the card as the plain version computes them (no powf here).
//  * Merge.  The chunks of a (kv head, slot) are one thread-block
//    cluster.  Each block keeps its partial (max, denominator,
//    unnormalised output) in its own shared memory; after a cluster
//    barrier every block merges its share of the outputs from all the
//    partials through distributed shared memory, in chunk order, so two
//    launches are bit-equal.  This takes neither of the two merges first
//    planned: a second kernel costs a launch on a host-bound path, and
//    the last-arriving block's merge (an arrival count in device memory,
//    tried first) put a fence, an atomic and two dependent round trips
//    through L2 on the critical path.  No scratch, no counters; the
//    wrapper allocates only the output.
//  * The append.  The block whose chunk holds pos[b] writes the new rows
//    to the caches after the first cluster barrier, when every block of
//    the (kv head, slot) has read its tiles: no block reads row pos[b]
//    while it changes, and no block uses its stale copy.
//  * Query groups.  G, a template bound on the group H/Kv, is 1, 2, 4, 8
//    or 16; a lane keeps G * VPL * VEC query values in registers.  Groups
//    of 9-16 (nemotron-4-340b's 96/8 = 12, recurrentgemma-2b's 10/1) take
//    the G = 16 instantiation, built with __launch_bounds__(128, 2) so
//    its 128 query registers a lane fit without capping the others' at
//    128; groups up to 8 launch the instantiations they always did.  It
//    runs 2 blocks an SM, so the wrapper's split (planned at 3 an SM)
//    takes two waves at many (kv head, slot) pairs: nemotron-4-340b's
//    96/8 at 4,096 positions, 384 blocks.  A split into one wave (256
//    blocks of longer chunks) measured slower (scripts/time_ab.py).
//  * Shared memory stays under 48 KiB for the wrapper's tiles at every
//    hd with a group up to 12 (the scores and queries of a group of 12
//    at hd 192 take 11 KiB beside a 32 KiB tile); above that (a group of
//    16 at hd 256) the launcher sets the kernel's dynamic shared memory
//    attribute to what the launch needs, up to 227 KiB, once per size.
//    Clusters of more than 8 blocks take an opt-in attribute, set once
//    per kernel.
//
// Where the numbers can go wrong:
//  * The new k/v rows are rounded through bf16 (round to nearest even)
//    and attention reads the rounded row, as the reference does.
//  * Built without fast math and with --fmad=false; the norm and rope
//    (norm_rope, the same code in every block, so the k row a block uses
//    is the one written) use _rn intrinsics in the reference's order and
//    cosf/sinf of pos * freq as torch computes it on the card.  Still,
//    the rmsnorm sum is a float sum in another order than torch's, so a
//    bf16 k row can, rarely, land one bf16 step away (chip_smoke.py
//    reports how many did).
//  * The output is a two-pass softmax within each tile (the query scaled
//    by 1/sqrt(hd) once, dot products and P.V as explicit fused
//    multiply-adds) merged across tiles and chunks by exp(m_part - m),
//    not the reference's one softmax over all positions: float order
//    differs, within check.ATTN_TOL = 2e-5.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;
constexpr int kMaxHd = 256;
constexpr int kPPL = 4;                 // rope pairs a lane holds: hd <= 256
constexpr int kMaxChunks = 16;          // a cluster's blocks (non-portable)
constexpr size_t kSmemLimit = 48 * 1024;        // without an attribute
constexpr size_t kSmemOptIn = 227 * 1024;       // a block's most, opted in

__host__ __device__ __forceinline__ size_t up16(size_t v) {
  return (v + 15) / 16 * 16;
}

// Dynamic shared memory, in order: the K and V tiles (bf16; after the
// last tile, the block's partial: m[group], l[group], o[group][hd] f32),
// the two new rows (bf16), the group's scaled queries and a tile's scores
// (f32; in the merge, the chunks' maxima and denominators).
__host__ __device__ __forceinline__ size_t tile_bytes(int sr, int hd, int group) {
  const size_t stage = (size_t)4 * sr * hd;
  const size_t part = sizeof(float) * (size_t)group * (hd + 2);
  return up16(stage > part ? stage : part);
}
size_t smem_bytes(int sr, int hd, int group) {
  const int scores = sr > 2 * kMaxChunks ? sr : 2 * kMaxChunks;
  return tile_bytes(sr, hd, group) + up16((size_t)4 * hd) +
         sizeof(float) * (size_t)group * (hd + scores);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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
  // through the read-only path: every block of a (kv head, slot) reads
  // the same queries, every block the same gains
  __device__ __forceinline__ void load(const float* src, int lane, int half) {
#pragma unroll
    for (int s = 0; s < 2 * PPL; ++s)
      v[s] = ok(s, lane, half) ? __ldg(src + elem(s, lane, half)) : 0.f;
  }
};

// rmsnorm (optional, with the lane's gains) + rope at `pos` (freq: rope's
// frequencies theta^(-j/half) of the lane's pairs j = lane + 32*i, as
// the plain version computes them) of one vector held as Lanes.
template <int PPL>
__device__ void norm_rope(Lanes<PPL>& x, const Lanes<PPL>& gain, int qk_norm,
                          const float* freq, int pos, int lane, int half) {
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
        x.v[s] = __fmul_rn(__fmul_rn(x.v[s], r), gain.v[s]);
  }
  if (freq != nullptr) {
#pragma unroll 1
    for (int i = 0; i < PPL; ++i) {   // rolled: one copy of cosf and sinf
      if (lane + 32 * i >= half) break;
      const float ang = __fmul_rn((float)pos, freq[i]);
      const float c = cosf(ang), s = sinf(ang);
      const float x1 = x.v[i], x2 = x.v[PPL + i];
      x.v[i] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
      x.v[PPL + i] = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    }
  }
}

// VEC bf16 values (16 or 4 bytes, aligned) as floats.
template <int VEC>
__device__ __forceinline__ void load_bf16(float* dst,
                                          const __nv_bfloat16* src) {
  uint32_t w[VEC / 2];
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Args {
  const float* q; long long q_bs;
  const float* kn; long long k_bs;
  const float* vn; long long v_bs;
  const float* q_gain; const float* k_gain; const float* freqs;
  __nv_bfloat16* kc; __nv_bfloat16* vc;
  const int32_t* pos; int pos_stride;
  float* out; __nv_bfloat16* krow; __nv_bfloat16* vrow;
  int H, Kv, S, hd, chunks, rows, sr;
  int window, qk_norm, append;
  float inv_sqrt_hd;
};

// One block per (chunk, kv head, slot); the chunks of a (kv head, slot)
// form one cluster.  G: a bound on the query group H/Kv (1, 2, 4, 8 or
// 16).  VEC: bf16 values a copy and a vector load move, 8 (16 bytes) or
// 2 (4 bytes, where hd % 8 != 0).
template <int G>
__host__ __device__ constexpr int group_slots() { return G > 8 ? G : 8; }

template <int G, int VEC>
__global__ void __launch_bounds__(kThreads, G > 8 ? 2 : 4)
decode_attention_kernel(const __grid_constant__ Args a) {
  using L = Lanes<kPPL>;
  // vectors of a row a lane holds in the score pass: a lane keeps
  // G * VPL * VEC query values in registers (32, 64 at G = 8, 128 at 16)
  constexpr int VPL = VEC == 8 ? (G < 4 ? 4 / G : 1) : (G < 4 ? 16 / G : 4);
  constexpr int E = VPL * VEC;
  constexpr int HPW = (G + kWarps - 1) / kWarps;   // heads a warp softmaxes
  const int hd = a.hd, half = hd / 2, sr = a.sr;
  const int group = a.H / a.Kv;
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t slot = (size_t)b * a.Kv + kvh;
  const size_t row0 = ((size_t)b * a.S * a.Kv + kvh) * hd;   // cache row t at row0 + t*Kv*hd
  const size_t rstride = (size_t)a.Kv * hd;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + (size_t)sr * hd;
  float* pm = reinterpret_cast<float*>(smem);    // the partial, after the tiles
  __nv_bfloat16* kr = reinterpret_cast<__nv_bfloat16*>(smem + tile_bytes(sr, hd, group));
  __nv_bfloat16* vr = kr + hd;                   // the new rows, bf16
  float* qs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(kr) + up16((size_t)4 * hd));
  float* sc = qs + group * hd;                   // [group][sr]
  __shared__ float w_alpha[group_slots<G>()], w_den[group_slots<G>()];

  // K or V rows [t0, t1) of the tile at c0 + k*sr, skipping row `skip`;
  // one commit
  auto stage = [&](__nv_bfloat16* tile, const __nv_bfloat16* cache, int tt,
                   int t0, int t1, int skip) {
    const int upr = hd / VEC;
    for (int u = tid; u < (t1 - t0) * upr; u += kThreads) {
      const int r = u / upr, c = (u - r * upr) * VEC;
      if (t0 + r == skip) continue;
      const __nv_bfloat16* src = cache + row0 + (t0 + r) * rstride + c;
      __nv_bfloat16* dst = tile + (size_t)(t0 + r - tt) * hd + c;
      if constexpr (VEC == 8)
        async_copy::cp16(dst, src, true);
      else
        async_copy::cp4(dst, src, true);
    }
    async_copy::commit();
  };

  // 0. loads that need no position: the warp's first vector, its gains,
  // rope's frequencies, and the chunk's first tile (row pos[b] among
  // them is replaced below by the row this kernel makes)
  const int p = __ldg(a.pos + (size_t)b * a.pos_stride);
  L x, gn;
  if (warp < group + 2) x.load(warp < group ? a.q + (size_t)b * a.q_bs + (size_t)(kvh * group + warp) * hd
                                            : (warp == group ? a.kn + (size_t)b * a.k_bs : a.vn + (size_t)b * a.v_bs) + (size_t)kvh * hd,
                               lane, half);
  if (a.qk_norm && warp <= group)
    gn.load(warp < group ? a.q_gain : a.k_gain, lane, half);
  float fr[kPPL];
#pragma unroll
  for (int i = 0; i < kPPL; ++i)
    fr[i] = a.freqs != nullptr && lane + 32 * i < half ? __ldg(a.freqs + lane + 32 * i) : 0.f;
  const int c0 = chunk * a.rows;
  const int c1 = c0 + a.rows < a.S ? c0 + a.rows : a.S;
  {
    const int t1 = c0 + sr < c1 ? c0 + sr : c1;
    stage(ks, a.kc, c0, c0, t1, -1);
    stage(vs, a.vc, c0, c0, t1, -1);
  }

  // this chunk's positions that are read: [tb, te), in tiles c0 + k*sr
  const int t_hi = p < a.S - 1 ? p : a.S - 1;
  int t_lo = 0;
  if (a.window > 0 && p - a.window + 1 > 0) t_lo = p - a.window + 1;
  const int tb = c0 > t_lo ? c0 : t_lo;
  const int te = c1 < t_hi + 1 ? c1 : t_hi + 1;
  const int k_lo = (tb - c0) / sr, k_hi = te > tb ? (te - 1 - c0) / sr + 1 : k_lo;
  const int pc = p < 0 ? 0 : (p < a.S ? p : a.S - 1);
  const bool owner = pc / a.rows == chunk;       // makes the new rows

  // 1. norm + rope of the queries (scaled by 1/sqrt(hd)); in the owner
  // also of the new k row, and the bf16 k/v rows into shared memory
  const int nvec = owner ? group + 2 : (k_hi > k_lo ? group : 0);
  for (int j = warp; j < nvec; j += kWarps) {
    if (j != warp) {
      x.load(j < group ? a.q + (size_t)b * a.q_bs + (size_t)(kvh * group + j) * hd
                       : (j == group ? a.kn + (size_t)b * a.k_bs : a.vn + (size_t)b * a.v_bs) + (size_t)kvh * hd,
             lane, half);
      if (a.qk_norm && j <= group) gn.load(j < group ? a.q_gain : a.k_gain, lane, half);
    }
    if (j <= group)
      norm_rope<kPPL>(x, gn, a.qk_norm, a.freqs != nullptr ? fr : nullptr, p, lane, half);
#pragma unroll
    for (int s = 0; s < 2 * kPPL; ++s) {
      if (!L::ok(s, lane, half)) continue;
      const int d = L::elem(s, lane, half);
      if (j < group) {
        qs[j * hd + d] = __fmul_rn(x.v[s], a.inv_sqrt_hd);
        continue;
      }
      (j == group ? kr : vr)[d] = __float2bfloat16_rn(x.v[s]);
    }
  }

  // 2. the tiles: K(k) lands while the last P.V runs, V(k) while the
  // scores of tile k run; no rescale within a tile
  const int nv = hd / VEC;
  int lpr = 1;                       // lanes a row: a power of two
  while (lpr * VPL < nv) lpr <<= 1;
  const int sub = lane & (lpr - 1);
  const int rpw = 32 / lpr, nrs = kWarps * rpw;
  const int rs = warp * rpw + lane / lpr;
  float qr[G][E];
  float acc[G][2];                   // P.V: pairs e = tid + kThreads*k
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k][0] = acc[k][1] = 0.f;
#pragma unroll
  for (int h = 0; h < HPW; ++h) m_run[h] = -INFINITY, l_run[h] = 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    const int tt = c0 + k * sr;        // the tile's first row
    const int r_lo = (tb > tt ? tb : tt) - tt;
    const int r_hi = (te < tt + sr ? te : tt + sr) - tt;
    if (k == k_lo && k > 0) {          // the first tile was not this one:
      async_copy::wait<0>();           // its copies land before these
      __syncthreads();
      stage(ks, a.kc, tt, tt + r_lo, tt + r_hi, p);
      stage(vs, a.vc, tt, tt + r_lo, tt + r_hi, p);
    }
    async_copy::wait<1>();             // K(k)
    __syncthreads();
    if (k == k_lo) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int vi = sub + lpr * i;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            qr[g][i * VEC + e] = g < group && vi < nv ? qs[g * hd + vi * VEC + e] : 0.f;
        }
    }
    // scores: a row's dot products over lpr lanes, one shuffle tree
    for (int r0 = r_lo; r0 < r_hi; r0 += nrs) {
      const int r = r0 + rs;
      const __nv_bfloat16* row = tt + r == p ? kr : ks + (size_t)r * hd;
      float kv[E];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = sub + lpr * i;
        if (r < r_hi && vi < nv) {
          load_bf16<VEC>(kv + i * VEC, row + vi * VEC);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[i * VEC + e] = 0.f;
        }
      }
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            t = __fmaf_rn(qr[g][i * VEC + e], kv[i * VEC + e], t);
          d[g] = __fadd_rn(d[g], t);
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          d[g] = __fadd_rn(d[g], __shfl_xor_sync(0xffffffffu, d[g], o));
      if (sub == 0 && r < r_hi)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g < group) sc[g * sr + r] = d[g];
    }
    __syncthreads();                   // the scores; K(k) is free
    if (k + 1 < k_hi) {
      const int tn = tt + sr;
      stage(ks, a.kc, tn, tn, te < tn + sr ? te : tn + sr, p);
    } else {
      async_copy::commit();
    }
    async_copy::wait<1>();             // V(k)

    // softmax per head: the running max and denominator, exp in place,
    // the factor that rescales the earlier tiles' P.V
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = warp + kWarps * h;
      if (g >= group) continue;
      float* s = sc + g * sr;
      float mx = -INFINITY;
      for (int r = r_lo + lane; r < r_hi; r += 32) mx = fmaxf(mx, s[r]);
      const float m_new = fmaxf(m_run[h], warp_max(mx));
      const float alpha =
          m_run[h] == -INFINITY ? 0.f : expf(__fsub_rn(m_run[h], m_new));
      float l = 0.f;
      for (int r = r_lo + lane; r < r_hi; r += 32) {
        const float e = expf(__fsub_rn(s[r], m_new));
        s[r] = e;
        l = __fadd_rn(l, e);
      }
      l_run[h] = __fadd_rn(__fmul_rn(l_run[h], alpha), warp_sum(l));
      m_run[h] = m_new;
      if (lane == 0) w_alpha[g] = alpha;
    }
    __syncthreads();                   // p, alpha and V(k) visible

    // P.V: a thread per (head, pair of dims), rows in order
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int e = tid + kThreads * kk;
      if (e >= group * half) continue;
      const int g = e / half, d = 2 * (e - g * half);
      const float al = w_alpha[g];
      const float* pg = sc + g * sr;
      float o0 = __fmul_rn(acc[kk][0], al), o1 = __fmul_rn(acc[kk][1], al);
      for (int r = r_lo; r < r_hi; ++r) {
        const __nv_bfloat16* row = tt + r == p ? vr : vs + (size_t)r * hd;
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + d));
        o0 = __fmaf_rn(pg[r], v.x, o0);
        o1 = __fmaf_rn(pg[r], v.y, o1);
      }
      acc[kk][0] = o0, acc[kk][1] = o1;
    }
    __syncthreads();                   // V(k) is free
    if (k + 1 < k_hi) {
      const int tn = tt + sr;
      stage(vs, a.vc, tn, tn, te < tn + sr ? te : tn + sr, p);
    } else {
      async_copy::commit();
    }
  }
  async_copy::wait<0>();               // a first tile this chunk never read
  __syncthreads();

  // 3. the block's partial into its own shared memory (an empty chunk:
  // max -inf, denominator 0, output 0)
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int g = warp + kWarps * h;
    if (g < group && lane == 0) pm[g] = m_run[h], pm[group + g] = l_run[h];
  }
#pragma unroll
  for (int kk = 0; kk < G; ++kk) {
    const int e = tid + kThreads * kk;
    if (e >= group * half) continue;
    const int g = e / half, d = 2 * (e - g * half);
    pm[2 * group + g * hd + d] = acc[kk][0];
    pm[2 * group + g * hd + d + 1] = acc[kk][1];
  }

  // 4. merge across the cluster (its blocks are this (kv head, slot)'s
  // chunks, rank = chunk) through distributed shared memory.  After the
  // first barrier every partial is visible and every block has read its
  // tiles, so the owner writes the new rows out now (appended to the
  // caches: no block reads row pos[b] while it changes).  Each block
  // merges its share of the outputs, a thread an output: one round trip
  // brings every chunk's max, denominator and value, summed in chunk
  // order.  Every block passes a second barrier before it exits, so its
  // shared memory outlives the others' reads.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (owner)
    for (int d = tid; d < hd; d += kThreads) {
      if (!a.append) {
        a.krow[slot * hd + d] = kr[d];
        a.vrow[slot * hd + d] = vr[d];
      } else if (p >= 0 && p < a.S) {
        a.kc[row0 + p * rstride + d] = kr[d];
        a.vc[row0 + p * rstride + d] = vr[d];
      }
    }
  const int C = a.chunks;
  const int per = (group * hd + C - 1) / C;      // outputs this block merges
  const int e1 = (chunk + 1) * per < group * hd ? (chunk + 1) * per : group * hd;
  // one round trip: every chunk's max and denominator into shared
  // memory, the chunks' values of this thread's first output into
  // registers
  float* wm = sc;                                // [C][group], then weights
  float* wl = sc + kMaxChunks * group;
  for (int i = tid; i < C * group; i += kThreads) {
    const float* rp = cluster.map_shared_rank(pm, i / group);
    wm[i] = rp[i % group];
    wl[i] = rp[group + i % group];
  }
  const int e0 = chunk * per + tid;
  float ov[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
    ov[c] = e0 < e1 && c < C ? cluster.map_shared_rank(pm, c)[2 * group + e0] : 0.f;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int g = warp + kWarps * h;
    if (g >= group) continue;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, wm[c * group + g]);
    m = warp_max(m);
    float den = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float mc = wm[c * group + g];
      const float f = mc == -INFINITY ? 0.f : expf(__fsub_rn(mc, m));
      wm[c * group + g] = f;           // now the chunk's weight
      den = __fmaf_rn(wl[c * group + g], f, den);
    }
    den = warp_sum(den);
    if (lane == 0) w_den[g] = den;
  }
  __syncthreads();
  for (int e = e0; e < e1; e += kThreads) {
    const int g = e / hd;
    float num = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c >= C) break;
      const float o = e == e0 ? ov[c] : cluster.map_shared_rank(pm, c)[2 * group + e];
      num = __fmaf_rn(o, wm[c * group + g], num);
    }
    a.out[((size_t)b * a.H + kvh * group) * hd + e] = __fdiv_rn(num, w_den[g]);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int G, int VEC>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.sr, a.hd, a.H / a.Kv);
  const size_t fixed = 2 * sizeof(float) * group_slots<G>();   // w_alpha, w_den
  if (smem + fixed > kSmemOptIn) return cudaErrorInvalidValue;
  auto kern = decode_attention_kernel<G, VEC>;
  // above 48 KiB the dynamic shared memory needs the attribute, raised
  // once to each larger size a launch asks for
  static size_t smem_allowed = kSmemLimit - fixed;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  // clusters of more than 8 blocks need an opt-in, once per kernel
  static bool wide_clusters = false;
  if (a.chunks > 8 && !wide_clusters) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_clusters = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.chunks, a.Kv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(const Args& a, int B, cudaStream_t stream) {
  const int group = a.H / a.Kv;
  if (group <= 1) return launch<1, VEC>(a, B, stream);
  if (group <= 2) return launch<2, VEC>(a, B, stream);
  if (group <= 4) return launch<4, VEC>(a, B, stream);
  if (group <= 8) return launch<8, VEC>(a, B, stream);
  return launch<16, VEC>(a, B, stream);
}

}  // namespace

// q (B,H,hd) f32 with batch stride q_bs (heads packed), kn/vn (B,Kv,hd)
// f32 with batch strides k_bs/v_bs; q_gain/k_gain (hd,) f32 (ignored
// unless qk_norm); freqs (hd/2,) f32, rope's frequencies
// theta^(-j/(hd/2)), or null for no rope; k/v caches (B,S,Kv,hd) bf16
// contiguous; pos int32, pos[b * pos_stride] (stride 0: one position for
// every slot), each in [0, S) (a position past the cache is written
// nowhere); out (B,H,hd) f32.  append != 0: the new bf16 rows go into
// the caches at pos and krow/vrow may be null; append == 0: into
// krow/vrow (B,Kv,hd) bf16 and the caches are only read.  The S
// positions are split into `chunks` <= 16 chunks of `rows` (chunks *
// rows >= S, the last chunk not empty), one cluster of `chunks` blocks
// per (kv head, slot); a chunk is read in tiles of `tile_rows` <= rows
// rows (ops.attention_tile_rows), refused where the block's shared memory
// exceeds 227 KiB.  window <= 0: no window.  hd even and <= 256, H / Kv
// <= 16.  Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(
    const void* q, long long q_bs, const void* kn, long long k_bs,
    const void* vn, long long v_bs, const void* q_gain, const void* k_gain,
    const void* freqs, void* k_cache, void* v_cache, const void* pos,
    int pos_stride, void* out, void* krow, void* vrow, int B, int H, int Kv,
    int S, int hd, int chunks, int rows, int tile_rows, int window,
    int qk_norm, int append,
    void* stream) {
  if (B <= 0) return 0;
  if (hd <= 0 || hd % 2 || hd > kMaxHd || Kv <= 0 || H % Kv ||
      H / Kv > kMaxGroup || S <= 0 || B > 65535 || Kv > 65535)
    return (int)cudaErrorInvalidValue;
  if (chunks <= 0 || chunks > kMaxChunks || rows <= 0 ||
      (long long)chunks * rows < S || (long long)(chunks - 1) * rows >= S ||
      tile_rows <= 0 || tile_rows > rows)
    return (int)cudaErrorInvalidValue;
  if (!append && (krow == nullptr || vrow == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q), a.q_bs = q_bs;
  a.kn = static_cast<const float*>(kn), a.k_bs = k_bs;
  a.vn = static_cast<const float*>(vn), a.v_bs = v_bs;
  a.q_gain = static_cast<const float*>(q_gain);
  a.k_gain = static_cast<const float*>(k_gain);
  a.freqs = static_cast<const float*>(freqs);
  a.kc = static_cast<__nv_bfloat16*>(k_cache);
  a.vc = static_cast<__nv_bfloat16*>(v_cache);
  a.pos = static_cast<const int32_t*>(pos), a.pos_stride = pos_stride;
  a.out = static_cast<float*>(out);
  a.krow = static_cast<__nv_bfloat16*>(krow);
  a.vrow = static_cast<__nv_bfloat16*>(vrow);
  a.H = H, a.Kv = Kv, a.S = S, a.hd = hd, a.chunks = chunks, a.rows = rows;
  a.sr = tile_rows;
  a.window = window, a.qk_norm = qk_norm, a.append = append;
  a.inv_sqrt_hd = (float)(1.0 / sqrt((double)hd));
  const bool wide = hd % 8 == 0 && (uintptr_t)k_cache % 16 == 0 &&
                    (uintptr_t)v_cache % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(wide ? launch_vec<8>(a, B, s) : launch_vec<2>(a, B, s));
}
