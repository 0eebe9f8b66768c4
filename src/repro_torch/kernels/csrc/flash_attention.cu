// Flash attention forward for Hopper.  Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention (_kernel).
//
// Tiled online-softmax attention: causal mask, sliding window, logit
// softcap, GQA (kv head = h / (H/Hk), K/V never repeated), positions
// aligned at the END when Sq != Sk, q/k/v read as (B,S,H,hd) through their
// strides (no transposes).  A query row with no visible key writes 0.
// When asked, it also writes each row's logsumexp lse = m + log(l), fp32
// (B, Sq, H) (+inf for a row with no visible key): the backward
// (ring_attention.cu::ring_step_bwd with one rank) recomputes P from it.
// One block owns a (b, h, 64-row q tile), heaviest tiles first, and walks
// the kv tiles inside the causal/window band; m, l and O stay on chip.
//
// Head dims: any multiple of 8 up to 256.  The tiles are instantiated at
// 16, 32, 64, 128 and 256 columns; a narrower head dim (h2o-danube-3-4b's
// 120, a SMOKE config's 24) runs in the next tile width, its columns past
// hd zero-filled on load (they add 0 to every score and give 0 output
// columns) and never stored.  The scale stays 1/sqrt(hd) of the real hd.
//
// Bound: at the serving and training shapes (S 1000-4096, hd 128) the work
// is ~4*S^2/2*hd operations per head against ~4*S*hd*2 bytes: the bf16
// tensor-core rate.
//
// bf16 (every full-width path): FA2 on mma.sync m16n8k16 (bf16 in, fp32
// accumulate), 4 warps of 16 q rows.  Q's fragments stay in registers; K/V
// tiles of 64 keys come through a 3-stage cp.async ring of XOR-swizzled
// bf16 tiles (conflict-free ldmatrix), one barrier a tile.  The mask acts
// only on tiles that cross the diagonal, the window's edge or Sk; the
// softcap is a template flag.  The softmax runs in the log2 domain on the
// fragments, and P, rounded to bf16 as SDPA does, is the A operand of
// O += P V from registers.  112 KB of shared memory at hd 128, two blocks
// an SM.  At hd 256 (recurrentgemma-9b) a warp's O strip alone takes 128
// registers a lane: Q's fragment of each k-step is read from shared
// memory where it is used, key tiles are 32 wide and the ring has 2
// stages (96 KB, two blocks an SM).  The 16-byte copies need q/k/v bases
// and strides 16-byte aligned (the wrapper checks).
//
// fp32 (only the fp32 parity checks): fp32 FMAs on the CUDA cores from
// fp32 shared tiles, since the tensor cores would round fp32 to TF32
// (194 KB of shared memory at hd 256, one block an SM).  The C entry point
// chooses by dtype.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 128;
// thread (ty, tx) = (tid / 8, tid % 8) owns q rows ty + 16*i (i < 4),
// score columns tx + 8*j (j < 8) and output columns tx + 8*j (j < HD/8)
constexpr int kRowsPerThread = kBQ / (kThreads / 8);
constexpr int kColsPerThread = kBK / 8;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;     // nullptr: not written
  int B, Sq, Sk, H, Hk;
  int hd;         // the real head dim: columns of q/k/v/o (<= the tile's)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float sm_scale;
};

// rows of the buffer that holds Ks[HD][kBK+1] and then Ps[kBQ][kBK+1]
template <int HD>
__host__ __device__ constexpr int ks_rows() {
  return HD > kBQ ? HD : kBQ;
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qs[HD][kBQ+1] + Ks/Ps + Vs[kBK][HD]
  return sizeof(float) *
         (HD * (kBQ + 1) + ks_rows<HD>() * (kBK + 1) + kBK * HD);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashParams p) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int kOutCols = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [HD][kBQ+1], d-major
  float* Ks = Qs + HD * (kBQ + 1);       // [HD][kBK+1], d-major
  float* Ps = Ks;                        // [kBQ][kBK+1], after S is done
  float* Vs = Ks + ks_rows<HD>() * (kBK + 1);  // [kBK][HD]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  // heaviest (latest) q tiles first: under causality they see most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.Hk);
  const int off = p.Sk - p.Sq;  // query i sits at position i + off

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the kv range [k_lo, k_hi) any row of this tile can see
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(p.Sk, q_last + off + 1);
  if (p.window > 0) k_lo = max(0, q0 + off - p.window + 1);

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[d * (kBQ + 1) + r] = qi < p.Sq && d < p.hd ? qg[qi * p.q_ss + d] : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's Ps/Vs reads are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int kj = k0 + r;
      const bool in = kj < p.Sk && d < p.hd;
      Ks[d * (kBK + 1) + r] = in ? kg[kj * p.k_ss + d] : 0.f;
      Vs[r * HD + d] = in ? vg[kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = Qs[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = Ks[d * (kBK + 1) + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, softcap, mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qp = q0 + ty + 16 * i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kp = k0 + tx + 8 * j;
        float x = s[i][j] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads sharing a row are 8 consecutive lanes
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // nothing visible yet: keep exp() away from (-inf) - (-inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
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
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRowsPerThread], vv[kOutCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) vv[j] = Vs[c * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kOutCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // out is contiguous (B, Sq, H, hd)
  float* og =
      static_cast<float*>(p.o) + ((long long)b * p.Sq * p.H + h) * p.hd;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = og + (long long)qi * p.H * p.hd;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      if (tx + 8 * j < p.hd) orow[tx + 8 * j] = acc[i][j] * inv;
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.Sq + qi) * p.H + h] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <int HD>
cudaError_t launch_f32(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ bf16 on the tensor cores ---
// Warp w owns q rows 16w..16w+15 of the block's tile; lane (gid, tig) =
// (lane / 4, lane % 4) holds rows gid and gid + 8 of that strip and, in
// every 8-column C tile, columns 2tig and 2tig + 1.
namespace mma_fwd {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kBQ == 16 * kWarps, "one 16-row strip a warp");

// Up to hd 128 a warp holds Q's fragments in registers for the whole kv
// loop, key tiles are kBK wide and the K/V ring has 3 stages (two tiles
// in flight).  At hd 256 a warp's fp32 O strip alone takes 128 registers
// a lane, and Q's fragments would take 64 more: so Q's fragment of each
// k-step is read from shared memory where it is used, key tiles are 32
// wide (S: 16 registers a lane) and the ring has 2 stages, 96 KB of
// shared memory, two blocks an SM.
template <int HD>
__host__ __device__ constexpr bool q_in_regs() {
  return HD <= 128;
}
template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD <= 128 ? kBK : 32;
}
template <int HD>
__host__ __device__ constexpr int stages() {
  return HD <= 128 ? 3 : 2;
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q [kBQ][HD] + K, V [stages][key_tile][HD], bf16
  return sizeof(__nv_bfloat16) *
         (kBQ * HD + 2 * stages<HD>() * key_tile<HD>() * HD);
}

// kCap: the softcap is on (its tanh stays out of the other kernel's
// registers)
template <int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const FlashParams p) {
  using tc::bf16;
  constexpr int kBK = key_tile<HD>();     // keys of a K/V tile
  constexpr int kStages = stages<HD>();   // K/V ring depth
  constexpr bool kQRegs = q_in_regs<HD>();
  constexpr int kKSteps = HD / 16;   // k-steps of Q K^T over hd
  constexpr int kOutTiles = HD / 8;  // 8-column C tiles of O
  constexpr int kSTiles = kBK / 8;   // 8-column C tiles of S
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);    // [kBQ][HD]
  bf16* Ks = Qs + kBQ * HD;                       // [kStages][kBK][HD]
  bf16* Vs = Ks + kStages * kBK * HD;             // [kStages][kBK][HD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row
  // heaviest (latest) q tiles first: under causality they see most keys.
  // Blocks start in x-fastest order, so the q tile is the slowest axis.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (p.H / p.Hk);
  const int off = p.Sk - p.Sq;  // query i sits at position i + off

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the kv tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(p.Sk, q_last + off + 1);
  if (p.window > 0) k_lo = max(0, q0 + off - p.window + 1);
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - 1) / kBK - t_lo + 1 : 0;

  auto load_kv = [&](int it) {
    const int st = it % kStages, k0 = (t_lo + it) * kBK;
    tc::load_tile<HD, kBK, kThreads>(Ks + st * kBK * HD, kg, p.k_ss, k0,
                                     p.Sk, p.hd);
    tc::load_tile<HD, kBK, kThreads>(Vs + st * kBK * HD, vg, p.v_ss, k0,
                                     p.Sk, p.hd);
  };
  // Q's group, then one group a K/V tile, kStages - 1 ahead
  tc::load_tile<HD, kBQ, kThreads>(Qs, qg, p.q_ss, q0, p.Sq, p.hd);
  tc::cp_async_commit();
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) load_kv(it);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();
  // Q's strip as A fragments: held for the whole kv loop, or (hd 256)
  // read again at each k-step
  auto q_frag = [&](uint32_t(&a)[4], int ks) {
    tc::ldmatrix_x4(a, Qs + tc::swz<HD>(warp * 16 + (lane & 15),
                                        2 * ks + (lane >> 4)));
  };
  uint32_t qf[kQRegs ? kKSteps : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) q_frag(qf[ks], ks);
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max (log2 domain) and this lane's part of the running sum, for
  // rows gid and gid + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the scores' factor into the log2 domain (the softcap applies its own)
  const float sc = kCap ? 1.f : p.sm_scale * kLog2e;
  const int qp0 = q0 + warp * 16 + gid + off;  // position of row gid

  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<kStages - 2>();  // tile it has landed
    // every warp is past tile it - 1: its stage takes tile it + kStages - 1
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    tc::cp_async_commit();
    const int k0 = (t_lo + it) * kBK;
    const bf16* Kt = Ks + (it % kStages) * kBK * HD;
    const bf16* Vt = Vs + (it % kStages) * kBK * HD;

    // S = Q K^T: each x4 load of K gives the B fragments of two key tiles
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      } else {
        q_frag(qa, ks);
      }
#pragma unroll
      for (int np = 0; np < kSTiles / 2; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, Kt + tc::swz<HD>(np * 16 + (mat >> 1) * 8 + mrow,
                                             2 * ks + (mat & 1)));
        tc::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // softcap (to the log2 domain), and the mask where the tile crosses
    // Sk, the causal diagonal or the window's edge
    const bool edge =
        k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > q0 + off) ||
        (p.window > 0 && k0 <= q0 + kBQ - 1 + off - p.window);
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if constexpr (kCap)
          x = p.softcap * tanhf(x * p.sm_scale / p.softcap) * kLog2e;
        if (edge) {
          const int kp = k0 + 8 * j + 2 * tig + (e & 1);
          const int qp = qp0 + 8 * (e >> 1);
          bool ok = kp < p.Sk;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragments in the log2 domain, the factor sc
    // folded into one FMA before each exp2; a row lives on 4 lanes
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx * sc);
      // nothing visible yet: keep exp2() away from (-inf) - (-inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = tc::exp2_fast(m[rr] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        s[j][2 * rr] = tc::exp2_fast(fmaf(s[j][2 * rr], sc, -m_use));
        s[j][2 * rr + 1] = tc::exp2_fast(fmaf(s[j][2 * rr + 1], sc, -m_use));
        rs += s[j][2 * rr] + s[j][2 * rr + 1];
      }
      l[rr] = l[rr] * alpha + rs;
      m[rr] = m_new;
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
        o[n][2 * rr] *= alpha;
        o[n][2 * rr + 1] *= alpha;
      }
    }

    // O += P V: P's C tiles are the A fragments, V's B fragments come
    // transposed from its [key][d] tile
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      tc::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < kOutTiles / 2; ++dp) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(
            vb, Vt + tc::swz<HD>(kk * 16 + (mat & 1) * 8 + mrow,
                                 2 * dp + (mat >> 1)));
        tc::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

  // out is contiguous (B, Sq, H, hd)
  bf16* og =
      static_cast<bf16*>(p.o) + ((long long)b * p.Sq * p.H + h) * p.hd;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = l[rr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = q0 + warp * 16 + gid + 8 * rr;
    if (qi >= p.Sq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    bf16* orow = og + (long long)qi * p.H * p.hd + 2 * tig;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n)
      if (8 * n < p.hd)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            tc::pack_bf16(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
    if (p.lse != nullptr && tig == 0)
      p.lse[((long long)b * p.Sq + qi) * p.H + h] =
          lr > 0.f ? m[rr] * kLn2 + logf(lr) : INFINITY;
  }
}

template <int HD, bool kCap>
cudaError_t launch_cap(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto* kernel = flash_fwd_mma_kernel<HD, kCap>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.H, p.B, (p.Sq + kBQ - 1) / kBQ);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  return p.softcap > 0.f ? launch_cap<HD, true>(p, stream)
                         : launch_cap<HD, false>(p, stream);
}

// registers, local (spill) bytes, dynamic shared bytes, resident blocks
// per SM of the kernel without softcap
template <int HD>
cudaError_t attrs(int* out) {
  constexpr size_t smem = smem_bytes<HD>();
  auto* kernel = flash_fwd_mma_kernel<HD, false>;
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

cudaError_t dispatch_hd(const FlashParams& p, int dtype,
                        cudaStream_t stream) {
  const bool bf = dtype == REPRO_BF16;
  if (!bf && dtype != REPRO_F32) return cudaErrorInvalidValue;
  switch (tile_width(p.hd)) {
    case 16:
      return bf ? mma_fwd::launch<16>(p, stream) : launch_f32<16>(p, stream);
    case 32:
      return bf ? mma_fwd::launch<32>(p, stream) : launch_f32<32>(p, stream);
    case 64:
      return bf ? mma_fwd::launch<64>(p, stream) : launch_f32<64>(p, stream);
    case 128:
      return bf ? mma_fwd::launch<128>(p, stream)
                : launch_f32<128>(p, stream);
    case 256:
      return bf ? mma_fwd::launch<256>(p, stream)
                : launch_f32<256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,Sq,H,hd), k/v: (B,Sk,Hk,hd), hd a multiple of 8 up to 256, with
// unit stride on hd and the given element strides for b, s, h; o:
// contiguous (B,Sq,H,hd) of q's dtype;
// lse: contiguous fp32 (B,Sq,H) or nullptr.  bf16 runs on the tensor
// cores and needs 16-byte aligned bases and b, s, h strides; fp32 runs on
// the FMA kernel.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq,
    int Sk, int H, int Hk, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float softcap, float sm_scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const FlashParams p{q,    k,    v,    o,    static_cast<float*>(lse),
                      B,    Sq,   Sk,   H,    Hk,
                      hd,   q_sb, q_ss, q_sh, k_sb,
                      k_ss, k_sh, v_sb, v_ss, v_sh,
                      causal, window, softcap, sm_scale};
  return dispatch_hd(p, dtype, static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's registers, spill bytes, dynamic shared memory and
// resident blocks per SM at head dim hd (its tile width's kernel), into
// out[0..3].
extern "C" int flash_attention_fwd_attrs(int hd, int* out) {
  switch (tile_width(hd)) {
    case 16: return mma_fwd::attrs<16>(out);
    case 32: return mma_fwd::attrs<32>(out);
    case 64: return mma_fwd::attrs<64>(out);
    case 128: return mma_fwd::attrs<128>(out);
    case 256: return mma_fwd::attrs<256>(out);
    default: return cudaErrorInvalidValue;
  }
}
