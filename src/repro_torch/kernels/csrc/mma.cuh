// Tensor-core building blocks of the bf16 attention kernels (sm_90a):
// cp.async copies into XOR-swizzled shared tiles, ldmatrix fragment loads
// and the m16n8k16 bf16 mma.sync with fp32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig): A (16 x 16,
// row-major) a0 = (gid, 2tig..+1), a1 = (gid+8, 2tig..), a2 = (gid,
// 8+2tig..), a3 = (gid+8, 8+2tig..); B (16 x 8, k x n) b0 = (2tig..+1,
// gid), b1 = (8+2tig.., gid); C (16 x 8) c0,c1 = (gid, 2tig..), c2,c3 =
// (gid+8, 2tig..).  So two neighbouring C tiles, rounded to bf16 pairs,
// are one A fragment: a score tile feeds the next product from registers.
#pragma once

#include "common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with in == false nothing is read and the chunk is
// zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4-byte async copy (a strided fp32 row value), zero-filled when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i receives its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: one 16 x 8 x 16 product, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (an attention weight that small adds nothing at bf16 or fp32)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from the C tiles 2kk and 2kk+1 of a
// 16-row strip (columns 16kk..16kk+15).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same, each value split as hi + lo with hi its bf16 rounding and lo
// the rest rounded to bf16: two products (hi, then lo) carry ~16 of its
// bits into an fp32 accumulator, where one carries 8.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  split_bf16(hi[0], lo[0], c0[0], c0[1]);
  split_bf16(hi[1], lo[1], c0[2], c0[3]);
  split_bf16(hi[2], lo[2], c1[0], c1[1]);
  split_bf16(hi[3], lo[3], c1[2], c1[3]);
}

// Element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile.
// The chunk index is XOR-ed with bits of the row so that the 8 rows an
// ldmatrix reads at one chunk column fall in 8 different 16-byte bank
// groups (a row holds D / 8 chunks: 16, 8, 4 or 2).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;
  static_assert(kChunks == 2 || kChunks == 4 || kChunks % 8 == 0,
                "row of 16, 32 or a multiple of 64 elements");
  int x;
  if constexpr (kChunks >= 8)
    x = c ^ (r & 7);
  else if constexpr (kChunks == 4)
    x = c ^ ((r >> 1) & 3);
  else
    x = c ^ ((r >> 2) & 1);
  return r * D + x * 8;
}

// Copy rows [row0, row0 + ROWS) of a bf16 matrix with row stride rs
// (elements) into a swizzled [ROWS][D] tile with cp.async; rows at or past
// n_rows, and the columns at or past cols (a multiple of 8: a row narrower
// than the tile), are zero-filled.  Every thread of the block takes part.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int row0,
                                          int n_rows, int cols = D) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows && c * 8 < cols;
    cp_async16(dst + swz<D>(r, c),
               src + (in ? (long long)(row0 + r) * rs + c * 8 : 0), in);
  }
}

}  // namespace tc
