// The gather loop shared by lut_matmul.cu and fused_qdot.cu (sm_90a).
//
// Both kernels sum, for each output (m, n), one 16-bit table entry
// T[ia][ib] per k, where ia comes from the activation row and ib from
// the weight column; fused_qdot adds the exact product a*b beside it.
// The gather is where the card's time goes: one shared-memory load per
// term.  A warp reads one table row (its 32 lanes are 32 columns of one
// row), so its bank pattern is set by the columns' ib and costs one to
// four wavefronts, depending on the data.  The load/store unit serves 32
// lanes per clock per SM, so any other shared-memory instruction in the
// loop costs as much as a gather.  The loop is built to need almost none:
//  * A is staged as packed bytes, row-major, 16 k to a 16-byte word: one
//    broadcast LDS.128 brings 16 k of a row into registers, and one PRMT
//    per term moves the byte into place as the row part ia << 8.
//  * Each thread sums R rows of one column, so each B byte (and its
//    column part of the address, computed once) serves R gathers.
//  * The exact product (fused_qdot) is one dp4a per 4 terms and row,
//    from the same A word and the column's 4 B bytes packed.
// Per term: PRMT, LEA, LDS.16, IADD; the R gathers of a k are
// independent, so each thread keeps R loads in flight.
#pragma once
#include <cstdint>

namespace gather_loop {

constexpr int kTableBytes = 256 * 256 * 2;   // 16-bit entries

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One 16-bit table entry at shared-memory byte address `addr`, widened as
// uint16 (U16) or int16.  The table is not written while it is read, so
// the loads need no ordering beyond their address operands.
template <bool U16>
__device__ __forceinline__ int lds16(uint32_t addr) {
  int v;
  if (U16)
    asm("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  else
    asm("ld.shared.s16 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// EXACT: 0 no exact part (lut_matmul), 1 uint8 x uint8, 2 int8 x int8.
//
// acc[r] += sum over 16 k of T[ia][ib] (+ a*b), for R rows of one column.
// a[r]: row r's 16 A bytes, k ascending from the low byte; ia is the byte
// XORed with `axor` (0x80 in each byte turns an int8 byte into its +128
// index).  b: the column's B byte at the first k, `bstride` bytes from
// one k to the next; ib = (byte + boff) & 255.  tab: the shared-memory
// address of the 256 x 256 table, row-major.
template <int R, bool U16, int EXACT>
__device__ __forceinline__ void gather16(uint32_t tab, const uint4 (&a)[R],
                                         const uint8_t* b, int bstride,
                                         uint32_t axor, int boff,
                                         int (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t bb[4], bo[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      bb[t] = b[(4 * j + t) * bstride];
      bo[t] = tab + (((bb[t] + boff) & 255u) << 1);
    }
    const uint32_t bw = bb[0] | (bb[1] << 8) | (bb[2] << 16) | (bb[3] << 24);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t w = word(a[r], j);
      if (EXACT == 1) acc[r] = (int)__dp4a(w, bw, (unsigned)acc[r]);
      if (EXACT == 2) acc[r] = __dp4a((int)w, (int)bw, acc[r]);
      const uint32_t wx = w ^ axor;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        // byte t of wx moved to bits 8..15: the entry's row part ia << 8
        const uint32_t ia8 = __byte_perm(wx, 0, 0x4404 | (t << 4));
        acc[r] += lds16<U16>((ia8 << 1) + bo[t]);
      }
    }
  }
}

// The same sum for one k; a: row 0's A byte at this k, rows `astride`
// bytes apart.
template <int R, bool U16, int EXACT>
__device__ __forceinline__ void gather1(uint32_t tab, const uint8_t* a,
                                        int astride, uint32_t bbyte,
                                        uint32_t axor, int boff,
                                        int (&acc)[R]) {
  const uint32_t bo = tab + (((bbyte + boff) & 255u) << 1);
  const int bv = EXACT == 2 ? (int)(int8_t)bbyte : (int)bbyte;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t ab = a[r * astride];
    if (EXACT) acc[r] += (EXACT == 2 ? (int)(int8_t)ab : (int)ab) * bv;
    acc[r] += lds16<U16>((((ab ^ axor) & 255u) << 9) + bo);
  }
}

// The sum over the first kn k of a staged run: A rows `apitch` bytes
// apart (16-byte aligned, as are apitch and A), B rows `bpitch` bytes
// apart, b pointing at this thread's column.
template <int R, bool U16, int EXACT>
__device__ __forceinline__ void gather_run(uint32_t tab, const uint8_t* A,
                                           int apitch, const uint8_t* B,
                                           int bpitch, int kn, uint32_t axor,
                                           int boff, int (&acc)[R]) {
  int kk = 0;
#pragma unroll 1
  for (; kk + 16 <= kn; kk += 16) {
    uint4 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      a[r] = *reinterpret_cast<const uint4*>(A + r * apitch + kk);
    gather16<R, U16, EXACT>(tab, a, B + kk * bpitch, bpitch, axor, boff,
                            acc);
  }
#pragma unroll 1
  for (; kk < kn; ++kk)
    gather1<R, U16, EXACT>(tab, A + kk, apitch, B[kk * bpitch], axor, boff,
                           acc);
}

}  // namespace gather_loop
