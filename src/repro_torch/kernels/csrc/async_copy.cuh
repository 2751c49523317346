// Asynchronous global -> shared copies for Hopper (sm_90a), shared by the
// gather kernels of this directory.
//
//  * cp.async (4 or 16 bytes a thread, zero-filled when the source is out
//    of range) stages the operand tiles; commit / wait_group give a
//    double buffer whose next stage loads while the current one is used.
//  * One bulk copy (the TMA's 1-D form, no tensor map) moves a whole
//    table into shared memory and signals an mbarrier with the bytes it
//    wrote, so the threads that stage the first operand tiles do not wait
//    for it.
//  * StreamK splits (output tile, k chunk) units evenly over a grid of
//    at most one CTA per SM, for calls whose output tiles alone would
//    leave most SMs idle.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes; only the first `n` (0 or 16) are read, the rest zero-filled.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when !in.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One thread: an mbarrier that completes when one arrival and the bulk
// copies' bytes have come in.  Call __syncthreads() before first use.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory and complete the barrier's phase with
// them.  Before it, the CTA must be done with the destination (a
// __syncthreads()); the proxy fence orders those generic-proxy reads
// before the async proxy's writes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  constexpr uint32_t kChunk = 32768;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  for (uint32_t off = 0; off < bytes; off += kChunk) {
    const uint32_t n = bytes - off < kChunk ? bytes - off : kChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(static_cast<char*>(dst) + off)),
           "l"(static_cast<const char*>(src) + off), "r"(n),
           "r"(smem_addr(bar))
        : "memory");
  }
}

// Every thread: wait for the barrier's phase `parity` (0, 1, 0, ...) to
// complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Stream-K: `tiles` output tiles of `chunks` k chunks each, as one run
// of tiles * chunks units in tile-major order.  CTA i of `grid` takes
// units [begin(i), begin(i + 1)): a contiguous run, so it walks whole k
// ranges of at most a few tiles, and no CTA has more than one unit more
// than another.  A tile shared by several CTAs gets its partial sums
// added into an output zeroed first (exact for integer sums).
struct StreamK {
  int tiles, chunks, grid;

  __host__ __device__ long long units() const {
    return (long long)tiles * chunks;
  }
  __host__ __device__ long long begin(int cta) const {
    return units() * cta / grid;
  }
};

// The grid of a stream-K launch: one CTA per SM, or one per unit when
// there are fewer units.
inline StreamK stream_k(int tiles, int chunks, int sms) {
  const long long units = (long long)tiles * chunks;
  return StreamK{tiles, chunks, (int)(units < sms ? units : sms)};
}

}  // namespace async_copy
