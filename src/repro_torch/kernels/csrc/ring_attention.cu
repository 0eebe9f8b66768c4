// Ring attention hop for Hopper, forward and backward.
//
// ring_step_fwd replaces the Pallas kernel
// repro/kernels/ring_attention.py::ring_step (_step_kernel): fold one
// visiting, padded KV block into the carried fp32 online-softmax state
// (m, l, acc).  ring_step_bwd is its VJP in the FA2 form; the JAX package
// has none (it differentiates the jnp fold), the training path needs it.
// With one rank it is the flash backward.
//
// One launch runs one ring step for EVERY rank: rank r's q chunk meets the
// KV block of rank hops[r].src, read in place (on one card the ring's roll
// is an index).  Tensors are contiguous with the rank axis first:
//   q, dout, dq        (R,  B, Cq, H,  HD)
//   k, v, dk, dv       (Rk, B, Ck, Hk, HD)
//   m, l, lse, delta   (R,  B, Cq, H)        acc (R, B, Cq, H, HD)
// The key j of a hop is visible to query i iff i < q_valid, j < k_valid
// and, causal, k_start + j <= q_start + i (global positions): q_valid and
// k_valid are the real (non-pad) rows of the two chunks.  Key tiles with
// no visible key are skipped, and so are q tiles wholly in the pad; a
// masked score adds p = 0 explicitly, so a row that sees no key keeps its
// carry bit for bit (alpha is exactly 1).
//
// Forward: one block a (rank, b, h, 64-row q tile) holds its carry in
// registers over the visible kv tiles, heaviest q tiles first.  Bound: the
// carry's fp32 read and write (at the training shapes more time at the
// byte rate than the visible products at the bf16 tensor-core rate).
//   bf16: the tensor-core flash forward (flash_attention.cu, mma_fwd)
// with the carry: 4 warps of 16 q rows, Q's fragments in registers, K/V
// through a 3-stage cp.async ring of swizzled bf16 tiles, S = Q K^T and
// acc += P V on mma.sync m16n8k16 with fp32 accumulators.  The carry is
// loaded into acc's C fragments and each row's (m, l) before the first key
// tile and stored unnormalised (no / l).  m stays in natural-log units, as
// the carry keeps it: p = exp2(s scale log2e - m log2e), so a row whose max
// does not move keeps m bit for bit and gets alpha = 1 exactly.  Because
// acc is not normalised, P enters PV split as two bf16 A fragments, hi +
// lo (~16 bits of P), not one: one bf16 P puts its rounding into sums the
// size of sqrt(l), beyond 2e-2 elementwise at the training shapes.  Tiles
// wholly in the pad and key tiles with no visible key are skipped; the
// mask acts only on tiles that cross k_valid, q_valid or the diagonal.
// 112 KB of shared memory at hd 128, two blocks an SM.
//   fp32 (the fp32 parity checks): fp32 FMAs from fp32 shared tiles; the
// tensor cores would round fp32 to TF32.
//
// Backward: one block a (rank, b, kv head, key tile) keeps the tile's dK
// and dV on chip over the G query heads and the q tiles that see it (from
// the causal diagonal to the window's far edge, up to the rank's
// q_valid), so dK/dV need no atomics (the hop sources are distinct within
// a launch, launches are ordered on the stream); dQ rows are summed
// across key tiles with fp32 atomics.  P = exp(s - lse) from the final
// logsumexp, dS = P * (dO V^T - delta); with a logit softcap s is the
// capped score cap * tanh(x / cap) and dS takes its derivative,
// 1 - (s / cap)^2.  The backward alone also takes a sliding window (key
// visible iff kpos > qpos - window, the flash forward's band) and any
// head dim that is a multiple of 8 up to 128: it runs in the next tile
// width (16, 32, 64, 128) with the columns past hd zero-filled on load
// and never stored.  Only the flash backward (one rank) passes a window, a
// softcap or such a head dim; the ring forward keeps the tile widths (the
// cp route refuses a window and a softcap, as JAX's does).  Bound: five
// products per visible (q, k) pair at the bf16 tensor-core rate.
//   bf16: FA2's backward on mma.sync m16n8k16 (fp32 accumulate).  Each
// warp owns 16 keys and their dK/dV C fragments; K and V load once a
// block, Q, dO, lse and delta of each q tile through a 2-stage cp.async
// ring of swizzled bf16 tiles.  S^T = K Q^T, P^T = exp2(...) (masked only
// on edge tiles), dP^T = V dO^T, dS^T = P^T (dP^T - delta); dV += P^T dO
// and dK += dS^T Q take P^T and dS^T as bf16 A fragments from registers
// (as SDPA rounds them); dS^T goes through shared memory for dQ = dS K,
// added with float2 atomics.  8 warps and 128 keys a block at hd >= 32
// (145 KB of shared memory at hd 128): against 4 warps and 64 keys it
// halves the dq atomics and Q/dO loads a key, and timed faster.
//   fp32 (the fp32 parity checks): fp32 FMAs from fp32 shared tiles; the
// tensor cores would round fp32 to TF32.
//
// The parameter blocks are __grid_constant__: the hop table is indexed by
// the block's rank in place, never copied to each thread's local memory.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxRanks = 64;
constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // kv rows per tile
constexpr int kLd = 65;        // padded row of a [.][64] shared tile
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

struct Hop {
  int q_start, src, k_start, k_valid, q_valid;
};

struct RingShape {
  int R, Rk, B, Cq, Ck, H, Hk, causal;
  float sm_scale;
  Hop hops[kMaxRanks];
};

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  RingShape s;
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  RingShape s;
  int hd;         // the real head dim: columns of q/k/v/dout (<= the tile's)
  int window;     // <= 0: no window; else key visible iff kpos > qpos - window
  float softcap;  // <= 0: no softcap; else scores cap * tanh(s / cap)
};

__device__ __forceinline__ bool visible(const RingShape& s, const Hop& hop,
                                        int qi, int kj, int k_valid) {
  return qi < hop.q_valid && kj < k_valid &&
         (!s.causal || hop.k_start + kj <= hop.q_start + qi);
}

// The backward's mask: the hop's, and inside the window (> 0) when there
// is one
__device__ __forceinline__ bool bwd_visible(const RingShape& s,
                                            const Hop& hop, int qi, int kj,
                                            int k_valid, int window) {
  return visible(s, hop, qi, kj, k_valid) &&
         (window <= 0 || hop.k_start + kj > hop.q_start + qi - window);
}

// The q rows [*q_begin, *q_end) of a hop that can see a key of the tile
// [k0, k0 + keys): from the causal diagonal to the window's far edge, cut
// to q_valid; *q_begin rounded down to a whole q tile.  Empty when
// *q_begin >= *q_end.
__device__ __forceinline__ void bwd_q_band(const RingShape& s,
                                           const Hop& hop, int k0, int keys,
                                           int k_valid, int q_valid,
                                           int window, int* q_begin,
                                           int* q_end) {
  int lo = 0, hi = q_valid;
  if (s.causal) lo = max(0, hop.k_start + k0 - hop.q_start);
  if (window > 0) {
    const int k_last = min(k0 + keys, k_valid) - 1;
    hi = min(hi, hop.k_start + k_last + window - hop.q_start);
  }
  *q_begin = (lo / kBQ) * kBQ;
  *q_end = lo < hi ? hi : 0;
}

// ------------------------------------------------------------- forward ---
// thread (ty, tx) = (tid / 8, tid % 8) owns q rows ty + 16*i (i < 4),
// score columns tx + 8*j (j < 8) and carry columns tx + 8*j (j < HD/8)
constexpr int kRows = kBQ / (kFwdThreads / 8);
constexpr int kCols = kBK / 8;

template <int HD>
__host__ __device__ constexpr int fwd_ks_rows() {
  return HD > kBQ ? HD : kBQ;
}

template <int HD>
constexpr size_t fwd_smem_bytes() {
  // Qs[HD][kLd] + Ks[HD][kLd] (then Ps[kBQ][kLd]) + Vs[kBK][HD]
  return sizeof(float) * (HD * kLd + fwd_ks_rows<HD>() * kLd + kBK * HD);
}

template <int HD>
__global__ void __launch_bounds__(kFwdThreads)
ring_fwd_kernel(const __grid_constant__ FwdParams p) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int kOutCols = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                             // [HD][kLd], d-major
  float* Ks = Qs + HD * kLd;                    // [HD][kLd], d-major
  float* Ps = Ks;                               // [kBQ][kLd], after S
  float* Vs = Ks + fwd_ks_rows<HD>() * kLd;     // [kBK][HD]

  const RingShape& s = p.s;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  // heaviest (latest) q tiles first: under causality they see most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int r = blockIdx.z / s.B, b = blockIdx.z % s.B;
  const Hop hop = s.hops[r];
  const int kvh = h / (s.H / s.Hk);
  const int k_valid = min(hop.k_valid, s.Ck);

  const long long q_row0 = ((long long)r * s.B + b) * s.Cq;    // row (r,b,0)
  const long long kv_row0 = ((long long)hop.src * s.B + b) * s.Ck;
  const float* qg = static_cast<const float*>(p.q) + (q_row0 * s.H + h) * HD;
  const float* kg =
      static_cast<const float*>(p.k) + (kv_row0 * s.Hk + kvh) * HD;
  const float* vg =
      static_cast<const float*>(p.v) + (kv_row0 * s.Hk + kvh) * HD;
  const long long q_rs = (long long)s.H * HD, kv_rs = (long long)s.Hk * HD;

  // keys [0, k_hi) of the visiting block can be visible to this tile
  const int q_last = min(q0 + kBQ, s.Cq) - 1;
  int k_hi = q0 < hop.q_valid ? k_valid : 0;  // a pad tile sees nothing
  if (s.causal) k_hi = min(k_hi, hop.q_start + q_last - hop.k_start + 1);

  // the carry in (rows past Cq are never stored)
  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    const long long row = (q_row0 + min(qi, s.Cq - 1)) * s.H + h;
    m[i] = p.m_in[row];
    l[i] = p.l_in[row];
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      acc[i][j] = p.acc_in[row * HD + tx + 8 * j];
  }

  if (k_hi > 0) {
    for (int idx = tid; idx < kBQ * HD; idx += kFwdThreads) {
      const int rr = idx / HD, d = idx % HD;
      const int qi = q0 + rr;
      Qs[d * kLd + rr] = qi < s.Cq ? qg[qi * q_rs + d] : 0.f;
    }
  }
  for (int k0 = 0; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's Ps/Vs reads are done
    for (int idx = tid; idx < kBK * HD; idx += kFwdThreads) {
      const int rr = idx / HD, d = idx % HD;
      const int kj = k0 + rr;
      const bool in = kj < s.Ck;
      Ks[d * kLd + rr] = in ? kg[kj * kv_rs + d] : 0.f;
      Vs[rr * HD + d] = in ? vg[kj * kv_rs + d] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[d * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[d * kLd + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, then the online-softmax update of each row; p = 0 when masked
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[kCols];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ok[j] = visible(s, hop, qi, k0 + tx + 8 * j, k_valid);
        sc[i][j] *= s.sm_scale;
        if (ok[j]) mx = fmaxf(mx, sc[i][j]);
      }
      // the 8 threads sharing a row are 8 consecutive lanes
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m_new == m[i] ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        sc[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += sc[i][j];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading Ks: reuse it as Ps
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Ps[(ty + 16 * i) * kLd + tx + 8 * j] = sc[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kOutCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) vv[j] = Vs[c * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOutCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // the carry out
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s.Cq) continue;
    const long long row = (q_row0 + qi) * s.H + h;
    if (tx == 0) {
      p.m_out[row] = m[i];
      p.l_out[row] = l[i];
    }
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      p.acc_out[row * HD + tx + 8 * j] = acc[i][j];
  }
}

// -------------------------------------- forward, bf16 on tensor cores ---
// The flash forward of flash_attention.cu (mma_fwd) with the ring's
// carry and hop table.  Warp w owns q rows 16w..16w+15 of the block's
// tile; lane (gid, tig) = (lane / 4, lane % 4) holds rows gid and gid + 8
// of that strip and, in every 8-column C tile, columns 2tig and 2tig + 1.
namespace mma_fwd {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;     // K/V ring depth: two tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == 16 * kWarps, "one 16-row strip a warp");

template <int HD>
constexpr size_t smem_bytes() {
  // Q [kBQ][HD] + K, V [kStages][kBK][HD], bf16
  return sizeof(__nv_bfloat16) * (kBQ * HD + 2 * kStages * kBK * HD);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
ring_fwd_mma_kernel(const __grid_constant__ FwdParams p) {
  using tc::bf16;
  constexpr int kKSteps = HD / 16;   // k-steps of Q K^T over hd
  constexpr int kOutTiles = HD / 8;  // 8-column C tiles of acc
  constexpr int kSTiles = kBK / 8;   // 8-column C tiles of S
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);    // [kBQ][HD]
  bf16* Ks = Qs + kBQ * HD;                       // [kStages][kBK][HD]
  bf16* Vs = Ks + kStages * kBK * HD;             // [kStages][kBK][HD]

  const RingShape& s = p.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row
  // heaviest (latest) q tiles first: under causality they see most keys.
  // Blocks start in x-fastest order, so the q tile is the slowest axis.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x;
  const int r = blockIdx.y / s.B, b = blockIdx.y % s.B;
  const Hop& hop = s.hops[r];
  const int kvh = h / (s.H / s.Hk);
  const int k_valid = min(hop.k_valid, s.Ck);
  const int q_valid = min(hop.q_valid, s.Cq);

  const long long q_row0 = ((long long)r * s.B + b) * s.Cq;    // row (r,b,0)
  const long long kv_row0 = ((long long)hop.src * s.B + b) * s.Ck;
  const long long q_rs = (long long)s.H * HD, kv_rs = (long long)s.Hk * HD;
  const bf16* qg = static_cast<const bf16*>(p.q) + (q_row0 * s.H + h) * HD;
  const bf16* kg =
      static_cast<const bf16*>(p.k) + (kv_row0 * s.Hk + kvh) * HD;
  const bf16* vg =
      static_cast<const bf16*>(p.v) + (kv_row0 * s.Hk + kvh) * HD;

  // keys [0, k_hi) of the visiting block can be visible to this tile; a
  // tile wholly in the pad sees none
  int k_hi = q0 < q_valid ? k_valid : 0;
  if (s.causal && k_hi > 0)
    k_hi = min(k_hi, hop.q_start + min(q0 + kBQ, q_valid) - 1 -
                         hop.k_start + 1);
  const int n_tiles = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  auto load_kv = [&](int it) {
    const int st = it % kStages, k0 = it * kBK;
    tc::load_tile<HD, kBK, kThreads>(Ks + st * kBK * HD, kg, kv_rs, k0,
                                     k_valid);
    tc::load_tile<HD, kBK, kThreads>(Vs + st * kBK * HD, vg, kv_rs, k0,
                                     k_valid);
  };
  if (n_tiles > 0) {
    // Q's group, then one group a K/V tile, kStages - 1 ahead
    tc::load_tile<HD, kBQ, kThreads>(Qs, qg, q_rs, q0, q_valid);
    tc::cp_async_commit();
#pragma unroll
    for (int it = 0; it < kStages - 1; ++it) {
      if (it < n_tiles) load_kv(it);
      tc::cp_async_commit();
    }
  }

  // the carry in, as the C fragments of acc and each row's m and l: m in
  // natural-log units, as it is stored; l whole on the tig == 0 lane and 0
  // on the others, whose partial sums add to it at the end.  Rows past Cq
  // (never stored) start as an empty carry.
  float o[kOutTiles][4];
  float m[2], l[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + warp * 16 + gid + 8 * rr;
    const long long row = (q_row0 + qi) * s.H + h;
    const bool in = qi < s.Cq;
    m[rr] = in ? p.m_in[row] : -1e30f;
    l[rr] = in && tig == 0 ? p.l_in[row] : 0.f;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      const float2 a =
          in ? *reinterpret_cast<const float2*>(p.acc_in + row * HD + 8 * n +
                                                2 * tig)
             : make_float2(0.f, 0.f);
      o[n][2 * rr] = a.x;
      o[n][2 * rr + 1] = a.y;
    }
  }

  if (n_tiles > 0) {
    tc::cp_async_wait<kStages - 1>();  // Q has landed
    __syncthreads();
    // Q's strip as A fragments, held for the whole kv loop
    uint32_t qf[kKSteps][4];
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
      tc::ldmatrix_x4(qf[ks], Qs + tc::swz<HD>(warp * 16 + (lane & 15),
                                               2 * ks + (lane >> 4)));
    const float sl2 = s.sm_scale * kLog2e;  // raw score -> log2 units
    const int qw = q0 + warp * 16 + gid;    // this lane's row gid

    for (int it = 0; it < n_tiles; ++it) {
      tc::cp_async_wait<kStages - 2>();  // tile it has landed
      // every warp is past tile it - 1: its stage takes tile it + 2
      __syncthreads();
      if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
      tc::cp_async_commit();
      const int k0 = it * kBK;
      const bf16* Kt = Ks + (it % kStages) * kBK * HD;
      const bf16* Vt = Vs + (it % kStages) * kBK * HD;

      // S = Q K^T (raw): each x4 load of K gives two key tiles' B
      // fragments
      float sc[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          uint32_t kb[4];
          tc::ldmatrix_x4(kb,
                          Kt + tc::swz<HD>(np * 16 + (mat >> 1) * 8 + mrow,
                                           2 * ks + (mat & 1)));
          tc::mma_bf16(sc[2 * np], qf[ks], kb[0], kb[1]);
          tc::mma_bf16(sc[2 * np + 1], qf[ks], kb[2], kb[3]);
        }
      }

      // the hop's mask, only where the tile crosses k_valid, q_valid or
      // the causal diagonal: a masked score is -inf, so its p is 0
      const bool edge = k0 + kBK > k_valid || q0 + kBQ > q_valid ||
                        (s.causal && hop.k_start + k0 + kBK - 1 >
                                         hop.q_start + q0);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kSTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(s, hop, qw + 8 * (e >> 1),
                         k0 + 8 * j + 2 * tig + (e & 1), k_valid))
              sc[j][e] = -INFINITY;
      }

      // online softmax on the fragments; m stays in natural-log units and
      // the exponent takes it as -m log2e, so a row whose max did not
      // move keeps m bit for bit and gets alpha = 1 exactly
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSTiles; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * rr], sc[j][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx * s.sm_scale);
        const float alpha =
            m_new == m[rr] ? 1.f : tc::exp2_fast((m[rr] - m_new) * kLog2e);
        // nothing visible yet (m = -inf): keep exp2 away from inf - inf
        const float nm = m_new == -INFINITY ? 0.f : -m_new * kLog2e;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) {
          sc[j][2 * rr] = tc::exp2_fast(fmaf(sc[j][2 * rr], sl2, nm));
          sc[j][2 * rr + 1] =
              tc::exp2_fast(fmaf(sc[j][2 * rr + 1], sl2, nm));
          rs += sc[j][2 * rr] + sc[j][2 * rr + 1];
        }
        l[rr] = l[rr] * alpha + rs;
        m[rr] = m_new;
#pragma unroll
        for (int n = 0; n < kOutTiles; ++n) {
          o[n][2 * rr] *= alpha;
          o[n][2 * rr + 1] *= alpha;
        }
      }

      // acc += P V with P split as bf16 hi + lo (the carry is not
      // normalised: one bf16 P would put its rounding, ~2e-3 of each
      // term, into sums of size sqrt(l)); V's B fragments come transposed
      // from its [key][d] tile
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        tc::c_to_a_split(ph, pl, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kOutTiles / 2; ++dp) {
          uint32_t vb[4];
          tc::ldmatrix_x4_trans(
              vb, Vt + tc::swz<HD>(kk * 16 + (mat & 1) * 8 + mrow,
                                   2 * dp + (mat >> 1)));
          tc::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
          tc::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
          tc::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
          tc::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
    tc::cp_async_wait<0>();  // no copy outlives the block
  }

  // the carry out, unnormalised; every row below Cq is written
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = l[rr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = q0 + warp * 16 + gid + 8 * rr;
    if (qi >= s.Cq) continue;
    const long long row = (q_row0 + qi) * s.H + h;
    if (tig == 0) {
      p.m_out[row] = m[rr];
      p.l_out[row] = lr;
    }
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n)
      *reinterpret_cast<float2*>(p.acc_out + row * HD + 8 * n + 2 * tig) =
          make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
  }
}

template <int HD>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto* kernel = ring_fwd_mma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.s.H, p.s.R * p.s.B, (p.s.Cq + kBQ - 1) / kBQ);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// registers, local (spill) bytes, dynamic shared bytes, resident blocks
// per SM
template <int HD>
cudaError_t attrs(int* out) {
  constexpr size_t smem = smem_bytes<HD>();
  auto* kernel = ring_fwd_mma_kernel<HD>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel,
                                                      kThreads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return e;
}

}  // namespace mma_fwd

// ------------------------------------------------------------ backward ---
// thread (ty, tx) = (tid / 16, tid % 16): in the score tiles it owns rows
// ty + 16*a and columns tx + 16*c (a, c < 4); in the dK/dV tiles key rows
// ty + 16*a and head-dim columns tx + 16*c (c < HD/16); in the dQ tile q
// rows ty + 16*a and the same head-dim columns.
template <int HD>
constexpr size_t bwd_smem_bytes() {
  // Qs, dOs, Ks, Vs [HD][kLd]; Ps, dSs [kBQ][kLd]; lse, delta [kBQ]
  return sizeof(float) * (4 * HD * kLd + 2 * kBQ * kLd + 2 * kBQ);
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
ring_bwd_kernel(const __grid_constant__ BwdParams p) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kDC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [HD][kLd], d-major
  float* dOs = Qs + HD * kLd;       // [HD][kLd]
  float* Ks = dOs + HD * kLd;       // [HD][kLd]
  float* Vs = Ks + HD * kLd;        // [HD][kLd]
  float* Ps = Vs + HD * kLd;        // [kBQ][kLd]
  float* dSs = Ps + kBQ * kLd;      // [kBQ][kLd]
  float* lse_s = dSs + kBQ * kLd;   // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const RingShape& s = p.s;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kBK;  // the first key tiles see the most
  const int kvh = blockIdx.y;
  const int r = blockIdx.z / s.B, b = blockIdx.z % s.B;
  const Hop hop = s.hops[r];
  const int G = s.H / s.Hk;
  const int k_valid = min(hop.k_valid, s.Ck);
  if (k0 >= k_valid) return;
  int q_begin, q_end;
  bwd_q_band(s, hop, k0, kBK, k_valid, hop.q_valid, p.window, &q_begin,
             &q_end);
  if (q_begin >= q_end) return;

  const int hd = p.hd;
  const long long q_row0 = ((long long)r * s.B + b) * s.Cq;
  const long long kv_row0 = ((long long)hop.src * s.B + b) * s.Ck;
  const long long q_rs = (long long)s.H * hd, kv_rs = (long long)s.Hk * hd;
  const float* kg =
      static_cast<const float*>(p.k) + (kv_row0 * s.Hk + kvh) * hd;
  const float* vg =
      static_cast<const float*>(p.v) + (kv_row0 * s.Hk + kvh) * hd;

  for (int idx = tid; idx < kBK * HD; idx += kBwdThreads) {
    const int rr = idx / HD, d = idx % HD;
    const int kj = k0 + rr;
    const bool in = kj < s.Ck && d < hd;
    Ks[d * kLd + rr] = in ? kg[kj * kv_rs + d] : 0.f;
    Vs[d * kLd + rr] = in ? vg[kj * kv_rs + d] : 0.f;
  }

  float dk[4][kDC], dv[4][kDC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qg = static_cast<const float*>(p.q) + (q_row0 * s.H + h) * hd;
    const float* og =
        static_cast<const float*>(p.dout) + (q_row0 * s.H + h) * hd;
    const float* lg = p.lse + q_row0 * s.H + h;
    const float* dg = p.delta + q_row0 * s.H + h;
    float* dqg = p.dq + (q_row0 * s.H + h) * hd;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the previous tile's reads of every buffer are done
      for (int idx = tid; idx < kBQ * HD; idx += kBwdThreads) {
        const int rr = idx / HD, d = idx % HD;
        const int qi = q0 + rr;
        const bool in = qi < s.Cq && d < hd;
        Qs[d * kLd + rr] = in ? qg[qi * q_rs + d] : 0.f;
        dOs[d * kLd + rr] = in ? og[qi * q_rs + d] : 0.f;
      }
      if (tid < kBQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < s.Cq ? lg[(long long)qi * s.H] : INFINITY;
        dl_s[tid] = qi < s.Cq ? dg[(long long)qi * s.H] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T on the same (row, column) ownership
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qv[a] = Qs[d * kLd + ty + 16 * a];
          ov[a] = dOs[d * kLd + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = Ks[d * kLd + tx + 16 * c];
          vv[c] = Vs[d * kLd + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[a][c] = fmaf(qv[a], kv[c], sc[a][c]);
            dp[a][c] = fmaf(ov[a], vv[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          // the capped score s_c = cap tanh(x / cap) and ds_c / dx
          float x = sc[a][c] * s.sm_scale, dcap = 1.f;
          if (p.softcap > 0.f) {
            const float t = tanhf(x / p.softcap);
            x = p.softcap * t;
            dcap = 1.f - t * t;
          }
          const float pv = bwd_visible(s, hop, q0 + i, k0 + j, k_valid,
                                       p.window)
                               ? expf(x - lse_s[i])
                               : 0.f;
          Ps[i * kLd + j] = pv;
          dSs[i * kLd + j] = pv * (dp[a][c] - dl_s[i]) * dcap;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q (scaled once at the end)
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float pj[4], sj[4], od[kDC], qd[kDC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = Ps[i * kLd + ty + 16 * a];
          sj[a] = dSs[i * kLd + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          od[c] = dOs[(tx + 16 * c) * kLd + i];
          qd[c] = Qs[(tx + 16 * c) * kLd + i];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kDC; ++c) {
            dv[a][c] = fmaf(pj[a], od[c], dv[a][c]);
            dk[a][c] = fmaf(sj[a], qd[c], dk[a][c]);
          }
      }

      // dQ += dS K * scale, summed over key tiles by atomics
      float dqa[4][kDC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kDC; ++c) dqa[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float si[4], kd[kDC];
#pragma unroll
        for (int a = 0; a < 4; ++a) si[a] = dSs[(ty + 16 * a) * kLd + j];
#pragma unroll
        for (int c = 0; c < kDC; ++c) kd[c] = Ks[(tx + 16 * c) * kLd + j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kDC; ++c)
            dqa[a][c] = fmaf(si[a], kd[c], dqa[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qi = q0 + ty + 16 * a;
        if (qi >= s.Cq) continue;
#pragma unroll
        for (int c = 0; c < kDC; ++c)
          if (tx + 16 * c < hd)
            atomicAdd(dqg + qi * q_rs + tx + 16 * c, dqa[a][c] * s.sm_scale);
      }
    }
  }

  // this block alone owns these dK/dV rows within the launch
  float* dkg = p.dk + (kv_row0 * s.Hk + kvh) * hd;
  float* dvg = p.dv + (kv_row0 * s.Hk + kvh) * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= s.Ck) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      if (tx + 16 * c >= hd) continue;
      const long long o = kj * kv_rs + tx + 16 * c;
      dkg[o] += dk[a][c] * s.sm_scale;
      dvg[o] += dv[a][c];
    }
  }
}

// ------------------------------------- backward, bf16 on tensor cores ---
// Warp w owns keys 16w..16w+15 of the block's tile in the S^T, dP^T, dK
// and dV products, and q rows 16w..16w+15 of the q tile in dQ; lane (gid,
// tig) = (lane / 4, lane % 4) holds rows gid and gid + 8 of its strip and,
// in every 8-column C tile, columns 2tig and 2tig + 1.
namespace mma_bwd {

constexpr int kStages = 2;     // Q/dO/lse/delta ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int W>
constexpr size_t smem_bytes() {
  // K, V [16 W][HD] + Q, dO [kStages][kBQ][HD] + dS^T [16 W][kBQ], bf16;
  // lse, delta [kStages][kBQ] fp32
  return sizeof(__nv_bfloat16) * (2 * 16 * W * HD + 2 * kStages * kBQ * HD +
                                  16 * W * kBQ) +
         sizeof(float) * 2 * kStages * kBQ;
}

// W warps own the block's 16 W keys; kCap: the softcap is on (its tanh
// stays out of the other variants' loop); kGen: a window or a head dim
// narrower than the tile (the tile-width, windowless variant keeps hd and
// the band as constants, so the causal llama path pays for neither)
template <int HD, int W, bool kCap, bool kGen>
__global__ void __launch_bounds__(32 * W)
ring_bwd_mma_kernel(const __grid_constant__ BwdParams p) {
  using tc::bf16;
  constexpr int kThreads = 32 * W;
  constexpr int kKeys = 16 * W;        // keys of the block's tile
  constexpr int kKSteps = HD / 16;     // k-steps over hd
  constexpr int kDTiles = HD / 8;      // 8-column C tiles over hd
  constexpr int kQTiles = kBQ / 8;     // 8-column C tiles over a q tile
  // dQ (kBQ x HD) is split among the warps: 4 strips of 16 q rows times
  // W / 4 column parts, each done in blocks of at most 64 columns
  constexpr int kParts = W / 4;
  constexpr int kPartTiles = kDTiles / kParts;
  constexpr int kDQTiles = kPartTiles < 8 ? kPartTiles : 8;
  static_assert(W % 4 == 0 && kPartTiles % 2 == 0, "whole x4 loads of dQ");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);   // [kKeys][HD]
  bf16* Vs = Ks + kKeys * HD;                     // [kKeys][HD]
  bf16* Qs = Vs + kKeys * HD;                     // [kStages][kBQ][HD]
  bf16* dOs = Qs + kStages * kBQ * HD;            // [kStages][kBQ][HD]
  bf16* dSs = dOs + kStages * kBQ * HD;           // [kKeys][kBQ], dS^T
  float* lse_s = reinterpret_cast<float*>(dSs + kKeys * kBQ);
  float* dl_s = lse_s + kStages * kBQ;            // lse, delta [kStages][kBQ]

  const RingShape& s = p.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row
  // the first key tiles see the most queries: they go first, and blocks
  // start in x-fastest order, so the key tile is the slowest axis
  const int k0 = blockIdx.z * kKeys;
  const int kvh = blockIdx.x;
  const int r = blockIdx.y / s.B, b = blockIdx.y % s.B;
  const Hop& hop = s.hops[r];
  const int G = s.H / s.Hk;
  const int k_valid = min(hop.k_valid, s.Ck);
  const int q_valid = min(hop.q_valid, s.Cq);
  if (k0 >= k_valid) return;
  const int window = kGen ? p.window : 0;
  // only the q tiles inside the tile's causal and window band
  int q_begin, q_end;
  bwd_q_band(s, hop, k0, kKeys, k_valid, q_valid, window, &q_begin, &q_end);
  if (q_begin >= q_end) return;
  const int n_qt = (q_end - q_begin + kBQ - 1) / kBQ;
  const int n_it = G * n_qt;  // (query head, q tile) pairs, head-major

  // the tiles' columns past hd are zero-filled
  const int hd = kGen ? p.hd : HD;
  const long long q_row0 = ((long long)r * s.B + b) * s.Cq;
  const long long kv_row0 = ((long long)hop.src * s.B + b) * s.Ck;
  const long long q_rs = (long long)s.H * hd, kv_rs = (long long)s.Hk * hd;
  const bf16* kg = static_cast<const bf16*>(p.k) + (kv_row0 * s.Hk + kvh) * hd;
  const bf16* vg = static_cast<const bf16*>(p.v) + (kv_row0 * s.Hk + kvh) * hd;

  auto load_q = [&](int it) {
    const int st = it % kStages;
    const int h = kvh * G + it / n_qt, q0 = q_begin + (it % n_qt) * kBQ;
    const long long head = q_row0 * s.H + h;
    tc::load_tile<HD, kBQ, kThreads>(
        Qs + st * kBQ * HD, static_cast<const bf16*>(p.q) + head * hd, q_rs,
        q0, q_valid, hd);
    tc::load_tile<HD, kBQ, kThreads>(
        dOs + st * kBQ * HD, static_cast<const bf16*>(p.dout) + head * hd,
        q_rs, q0, q_valid, hd);
    // lse and delta are strided by H: one 4-byte copy a row
    if (threadIdx.x < 2 * kBQ) {
      const int i = threadIdx.x & (kBQ - 1);
      const bool in = q0 + i < q_valid;
      const float* src = threadIdx.x < kBQ ? p.lse : p.delta;
      float* dst = threadIdx.x < kBQ ? lse_s : dl_s;
      tc::cp_async4(dst + st * kBQ + i,
                    src + head + (in ? (long long)(q0 + i) * s.H : 0), in);
    }
  };
  tc::load_tile<HD, kKeys, kThreads>(Ks, kg, kv_rs, k0, k_valid, hd);
  tc::load_tile<HD, kKeys, kThreads>(Vs, vg, kv_rs, k0, k_valid, hd);
  load_q(0);
  tc::cp_async_commit();

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale_log2 = s.sm_scale * kLog2e;
  const int kw = k0 + warp * 16 + gid;  // this lane's key of row gid
  // the warp's strip and column part of dQ
  const int dq_strip = warp & 3, dq_part = warp >> 2;

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<0>();  // K, V and tile it have landed
    // every warp is past tile it - 1 (its Q/dO stage and its dS^T reads):
    // that stage takes tile it + 1
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1);
    tc::cp_async_commit();
    const int st = it % kStages;
    const int h = kvh * G + it / n_qt, q0 = q_begin + (it % n_qt) * kBQ;
    const bf16* Qt = Qs + st * kBQ * HD;
    const bf16* dOt = dOs + st * kBQ * HD;
    const float* lse_t = lse_s + st * kBQ;
    const float* dl_t = dl_s + st * kBQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float sT[kQTiles][4], dpT[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t ka[4], va[4];
      const int arow = warp * 16 + (lane & 15), acol = 2 * ks + (lane >> 4);
      tc::ldmatrix_x4(ka, Ks + tc::swz<HD>(arow, acol));
      tc::ldmatrix_x4(va, Vs + tc::swz<HD>(arow, acol));
#pragma unroll
      for (int np = 0; np < kQTiles / 2; ++np) {
        const int brow = np * 16 + (mat >> 1) * 8 + mrow;
        const int bcol = 2 * ks + (mat & 1);
        uint32_t qb[4], ob[4];
        tc::ldmatrix_x4(qb, Qt + tc::swz<HD>(brow, bcol));
        tc::ldmatrix_x4(ob, dOt + tc::swz<HD>(brow, bcol));
        tc::mma_bf16(sT[2 * np], ka, qb[0], qb[1]);
        tc::mma_bf16(sT[2 * np + 1], ka, qb[2], qb[3]);
        tc::mma_bf16(dpT[2 * np], va, ob[0], ob[1]);
        tc::mma_bf16(dpT[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T = exp2(S^T scale log2e - lse log2e) under the hop's mask, and
    // dS^T = P^T (dP^T - delta); the mask only where the tile crosses
    // the diagonal, the window's far edge or a chunk's real rows.  With
    // the softcap, P^T = exp(s_c - lse) of s_c = cap tanh(S^T scale / cap)
    // and dS^T takes its derivative, 1 - (s_c / cap)^2
    const bool edge = q0 + kBQ > q_valid || k0 + kKeys > k_valid ||
                      (s.causal && hop.k_start + k0 + kKeys - 1 >
                                       hop.q_start + q0) ||
                      (window > 0 && hop.k_start + k0 <=
                                         hop.q_start + q0 + kBQ - 1 -
                                             window);
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      const int qc = 8 * j + 2 * tig;  // this lane's q columns qc, qc + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse_t + qc);
      const float2 dl = *reinterpret_cast<const float2*>(dl_t + qc);
      const float nl0 = -ls.x * kLog2e, nl1 = -ls.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv, dcap = 1.f;
        if constexpr (kCap) {
          const float t = tanhf(sT[j][e] * s.sm_scale / p.softcap);
          dcap = 1.f - t * t;
          pv = tc::exp2_fast(
              fmaf(p.softcap * t, kLog2e, (e & 1) ? nl1 : nl0));
        } else {
          pv = tc::exp2_fast(
              fmaf(sT[j][e], scale_log2, (e & 1) ? nl1 : nl0));
        }
        if (edge && !bwd_visible(s, hop, q0 + qc + (e & 1),
                                 kw + 8 * (e >> 1), k_valid, window))
          pv = 0.f;
        sT[j][e] = pv;
        dpT[j][e] = pv * (dpT[j][e] - ((e & 1) ? dl.y : dl.x)) * dcap;
      }
    }

    // dS^T to shared memory for dQ, as bf16 pairs
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(
            dSs + tc::swz<kBQ>(warp * 16 + gid + 8 * rr, j) + 2 * tig) =
            tc::pack_bf16(dpT[j][2 * rr], dpT[j][2 * rr + 1]);

    // dV += P^T dO and dK += dS^T Q: A fragments from registers, dO and Q
    // as B fragments transposed from their [q][d] tiles
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      tc::c_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
      tc::c_to_a(sa, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        const int brow = kk * 16 + (mat & 1) * 8 + mrow;
        const int bcol = 2 * dp + (mat >> 1);
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, dOt + tc::swz<HD>(brow, bcol));
        tc::ldmatrix_x4_trans(qb, Qt + tc::swz<HD>(brow, bcol));
        tc::mma_bf16(dv[2 * dp], pa, ob[0], ob[1]);
        tc::mma_bf16(dv[2 * dp + 1], pa, ob[2], ob[3]);
        tc::mma_bf16(dk[2 * dp], sa, qb[0], qb[1]);
        tc::mma_bf16(dk[2 * dp + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // all of dS^T is in shared memory

    // dQ (this warp's 16 q rows and column part) = dS K * scale, added
    // into dq
    const int qr = q0 + dq_strip * 16 + gid;
    float* dqg = p.dq + (q_row0 * s.H + h) * hd;
#pragma unroll
    for (int d0 = dq_part * kPartTiles; d0 < (dq_part + 1) * kPartTiles;
         d0 += kDQTiles) {
      float dq[kDQTiles][4];
#pragma unroll
      for (int n = 0; n < kDQTiles; ++n)
        dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t sa[4];  // dS[q][key] from dS^T[key][q], transposed
        tc::ldmatrix_x4_trans(
            sa, dSs + tc::swz<kBQ>(kk * 16 + (mat >> 1) * 8 + mrow,
                                   2 * dq_strip + (mat & 1)));
#pragma unroll
        for (int dp = 0; dp < kDQTiles / 2; ++dp) {
          uint32_t kb[4];
          tc::ldmatrix_x4_trans(
              kb, Ks + tc::swz<HD>(kk * 16 + (mat & 1) * 8 + mrow,
                                   d0 + 2 * dp + (mat >> 1)));
          tc::mma_bf16(dq[2 * dp], sa, kb[0], kb[1]);
          tc::mma_bf16(dq[2 * dp + 1], sa, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qi = qr + 8 * rr;
        if (qi >= q_valid) continue;
        float* row = dqg + qi * q_rs + 8 * d0 + 2 * tig;
#pragma unroll
        for (int n = 0; n < kDQTiles; ++n)
          if (8 * (d0 + n) < hd)
            atomicAdd(reinterpret_cast<float2*>(row + 8 * n),
                      make_float2(dq[n][2 * rr] * s.sm_scale,
                                  dq[n][2 * rr + 1] * s.sm_scale));
      }
    }
  }

  // this block alone owns these dK/dV rows within the launch
  float* dkg = p.dk + (kv_row0 * s.Hk + kvh) * hd;
  float* dvg = p.dv + (kv_row0 * s.Hk + kvh) * hd;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = kw + 8 * rr;
    if (kj >= s.Ck) continue;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      if (8 * n >= hd) continue;
      const long long o = kj * kv_rs + 8 * n + 2 * tig;
      float2* pk = reinterpret_cast<float2*>(dkg + o);
      float2* pv = reinterpret_cast<float2*>(dvg + o);
      const float2 ok = *pk, ov = *pv;
      *pk = make_float2(ok.x + dk[n][2 * rr] * s.sm_scale,
                        ok.y + dk[n][2 * rr + 1] * s.sm_scale);
      *pv = make_float2(ov.x + dv[n][2 * rr], ov.y + dv[n][2 * rr + 1]);
    }
  }
}

// 8 warps (128 keys a block: half the dQ atomics and Q/dO loads of 64)
// where the dQ split allows, 4 at hd 16
template <int HD>
constexpr int warps() {
  return HD >= 32 ? 8 : 4;
}

template <int HD, bool kCap, bool kGen>
cudaError_t launch_variant(const BwdParams& p, cudaStream_t stream) {
  constexpr int W = warps<HD>();
  constexpr size_t smem = smem_bytes<HD, W>();
  auto* kernel = ring_bwd_mma_kernel<HD, W, kCap, kGen>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.s.Hk, p.s.R * p.s.B, (p.s.Ck + 16 * W - 1) / (16 * W));
  if (grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, 32 * W, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const bool gen = p.hd != HD || p.window > 0;
  if (p.softcap > 0.f)
    return gen ? launch_variant<HD, true, true>(p, stream)
               : launch_variant<HD, true, false>(p, stream);
  return gen ? launch_variant<HD, false, true>(p, stream)
             : launch_variant<HD, false, false>(p, stream);
}

// registers, local (spill) bytes, dynamic shared bytes, resident blocks
// per SM of the variant without softcap (kGen: with a window or a narrower
// head dim)
template <int HD, bool kGen>
cudaError_t attrs(int* out) {
  constexpr int W = warps<HD>();
  constexpr size_t smem = smem_bytes<HD, W>();
  cudaFuncAttributes a;
  auto* kernel = ring_bwd_mma_kernel<HD, W, false, kGen>;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel,
                                                      32 * W, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return e;
}

}  // namespace mma_bwd

// ------------------------------------------------------------- launch ---
template <int HD>
cudaError_t launch_fwd_f32(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      ring_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.s.Cq + kBQ - 1) / kBQ, p.s.H, p.s.R * p.s.B);
  ring_fwd_kernel<HD><<<grid, kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_f32(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      ring_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.s.Ck + kBK - 1) / kBK, p.s.Hk, p.s.R * p.s.B);
  ring_bwd_kernel<HD><<<grid, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(const FwdParams& p, int hd, bool bf,
                         cudaStream_t stream) {
  switch (hd) {
    case 16:
      return bf ? mma_fwd::launch<16>(p, stream)
                : launch_fwd_f32<16>(p, stream);
    case 32:
      return bf ? mma_fwd::launch<32>(p, stream)
                : launch_fwd_f32<32>(p, stream);
    case 64:
      return bf ? mma_fwd::launch<64>(p, stream)
                : launch_fwd_f32<64>(p, stream);
    case 128:
      return bf ? mma_fwd::launch<128>(p, stream)
                : launch_fwd_f32<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bwd_f32(const BwdParams& p, cudaStream_t stream) {
  switch (tile_width(p.hd)) {
    case 16: return launch_bwd_f32<16>(p, stream);
    case 32: return launch_bwd_f32<32>(p, stream);
    case 64: return launch_bwd_f32<64>(p, stream);
    case 128: return launch_bwd_f32<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bwd_mma(const BwdParams& p, cudaStream_t stream) {
  switch (tile_width(p.hd)) {
    case 16: return mma_bwd::launch<16>(p, stream);
    case 32: return mma_bwd::launch<32>(p, stream);
    case 64: return mma_bwd::launch<64>(p, stream);
    case 128: return mma_bwd::launch<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool make_shape(RingShape* s, int R, int Rk, int B, int Cq, int Ck, int H,
                int Hk, const int* hops, int causal, float sm_scale) {
  if (R <= 0 || R > kMaxRanks || Rk <= 0 || B <= 0 || Cq <= 0 || Ck < 0 ||
      H <= 0 || Hk <= 0 || H % Hk != 0 || R * B > 65535 || H > 65535)
    return false;
  *s = RingShape{R, Rk, B, Cq, Ck, H, Hk, causal, sm_scale, {}};
  for (int r = 0; r < R; ++r) {
    const int* e = hops + 5 * r;
    const Hop h{e[0], e[1], e[2], e[3], e[4]};
    if (h.src < 0 || h.src >= Rk || h.k_valid < 0 || h.k_valid > Ck ||
        h.q_valid < 0 || h.q_valid > Cq)
      return false;
    s->hops[r] = h;
  }
  return true;
}

}  // namespace

// One ring step for every rank: (m, l, acc)_out = fold(carry_in, hop).
// hops: R x (q_start, src, k_start, k_valid, q_valid).  bf16 runs on the
// tensor cores and needs 16-byte aligned q, k, v; fp32 on the FMA kernel.
extern "C" int ring_step_fwd(const void* q, const void* k, const void* v,
                             const void* m_in, const void* l_in,
                             const void* acc_in, void* m_out, void* l_out,
                             void* acc_out, int R, int Rk, int B, int Cq,
                             int Ck, int H, int Hk, int hd, const int* hops,
                             int causal, float sm_scale, int dtype,
                             void* stream) {
  FwdParams p{q,
              k,
              v,
              static_cast<const float*>(m_in),
              static_cast<const float*>(l_in),
              static_cast<const float*>(acc_in),
              static_cast<float*>(m_out),
              static_cast<float*>(l_out),
              static_cast<float*>(acc_out),
              {}};
  if (!make_shape(&p.s, R, Rk, B, Cq, Ck, H, Hk, hops, causal, sm_scale))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return dispatch_fwd(p, hd, false, st);
    case REPRO_BF16: return dispatch_fwd(p, hd, true, st);
    default: return cudaErrorInvalidValue;
  }
}

// One ring step's VJP for every rank, added into fp32 dq, dk, dv.  The
// hops' sources must be distinct (the wrapper checks).  bf16 runs on the
// tensor cores and needs 16-byte aligned q, k, v, dout; fp32 on the FMA
// kernel.
extern "C" int ring_step_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int R, int Rk, int B, int Cq, int Ck, int H,
                             int Hk, int hd, const int* hops, int causal,
                             int window, float softcap, float sm_scale,
                             int dtype, void* stream) {
  BwdParams p{q,
              k,
              v,
              dout,
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<float*>(dq),
              static_cast<float*>(dk),
              static_cast<float*>(dv),
              {},
              hd,
              window,
              softcap};
  if (!make_shape(&p.s, R, Rk, B, Cq, Ck, H, Hk, hops, causal, sm_scale))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return dispatch_bwd_f32(p, st);
    case REPRO_BF16: return dispatch_bwd_mma(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 backward's registers, spill bytes, dynamic shared memory and
// resident blocks per SM at head dim hd, into out[0..3]: the variant a
// windowless call without softcap launches (at a head dim narrower than
// its tile width, the general one).
extern "C" int ring_step_bwd_attrs(int hd, int* out) {
  const bool gen = hd != tile_width(hd);
  switch (tile_width(hd)) {
    case 16: return gen ? mma_bwd::attrs<16, true>(out)
                        : mma_bwd::attrs<16, false>(out);
    case 32: return gen ? mma_bwd::attrs<32, true>(out)
                        : mma_bwd::attrs<32, false>(out);
    case 64: return gen ? mma_bwd::attrs<64, true>(out)
                        : mma_bwd::attrs<64, false>(out);
    case 128: return gen ? mma_bwd::attrs<128, true>(out)
                         : mma_bwd::attrs<128, false>(out);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 forward's registers, spill bytes, dynamic shared memory and
// resident blocks per SM at head dim hd, into out[0..3].
extern "C" int ring_step_fwd_attrs(int hd, int* out) {
  switch (hd) {
    case 16: return mma_fwd::attrs<16>(out);
    case 32: return mma_fwd::attrs<32>(out);
    case 64: return mma_fwd::attrs<64>(out);
    case 128: return mma_fwd::attrs<128>(out);
    default: return cudaErrorInvalidValue;
  }
}
