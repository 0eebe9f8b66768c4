// Ring attention hop for Hopper, forward and backward.
//
// ring_step_fwd replaces the Pallas kernel
// repro/kernels/ring_attention.py::ring_step (_step_kernel): fold one
// visiting, padded KV block into the carried fp32 online-softmax state
// (m, l, acc).  ring_step_bwd is its VJP in the FA2 form; the JAX package
// has none (it differentiates the jnp fold), the training path needs it.
//
// One launch runs one ring step for EVERY rank: rank r's q chunk meets the
// KV block of rank hops[r].src, read in place (on one card the ring's roll
// is an index).  Tensors are contiguous with the rank axis first:
//   q, dout, dq        (R,  B, Cq, H,  HD)
//   k, v, dk, dv       (Rk, B, Ck, Hk, HD)
//   m, l, lse, delta   (R,  B, Cq, H)        acc (R, B, Cq, H, HD)
// The key j of a hop is visible to query i iff j < k_valid and, causal,
// k_start + j <= q_start + i (global positions).  Key tiles with no
// visible key are skipped; a masked score adds p = 0 explicitly, so a row
// that sees no key keeps its carry bit for bit (alpha is exactly 1).
//
// On the TPU the kv blocks were the sequential innermost grid dimension
// and the carry rode in VMEM refs.  Here the forward gives one block a
// (rank, b, h, 64-row q tile), loads its carry into registers, walks the
// visible kv tiles in a loop and writes the carry out; the scores never
// reach device memory.  Bound: at the training shapes (cp 4, S 4096,
// hd 128) the carry's fp32 read and write outweigh the visible products at
// the bf16 tensor rate.  Like the flash kernel, this first version
// multiplies with fp32 FMAs on the CUDA cores from fp32 shared-memory
// tiles, well above that bound (PERF.md).
//
// The backward gives one block a (rank, b, kv head, 64-key tile).  It
// keeps the tile's dK and dV in registers while it loops over the G query
// heads of its kv head and the q tiles that can see the tile, so dK/dV
// need no atomics (the hop sources are distinct within a launch, and
// launches are ordered on the stream); dQ rows are summed across key
// tiles with fp32 atomicAdd.  P = exp(s - lse) is recomputed from the
// final logsumexp, dS = P * (dO V^T - delta).
//
// The parameter blocks are __grid_constant__: the hop table is indexed by
// the block's rank in place, never copied to each thread's local memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxRanks = 64;
constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // kv rows per tile
constexpr int kLd = 65;        // padded row of a [.][64] shared tile
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

struct Hop {
  int q_start, src, k_start, k_valid;
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
};

__device__ __forceinline__ bool visible(const RingShape& s, const Hop& hop,
                                        int qi, int kj, int k_valid) {
  return qi < s.Cq && kj < k_valid &&
         (!s.causal || hop.k_start + kj <= hop.q_start + qi);
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

template <typename T, int HD>
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
  const T* qg = static_cast<const T*>(p.q) + (q_row0 * s.H + h) * HD;
  const T* kg = static_cast<const T*>(p.k) + (kv_row0 * s.Hk + kvh) * HD;
  const T* vg = static_cast<const T*>(p.v) + (kv_row0 * s.Hk + kvh) * HD;
  const long long q_rs = (long long)s.H * HD, kv_rs = (long long)s.Hk * HD;

  // keys [0, k_hi) of the visiting block can be visible to this tile
  const int q_last = min(q0 + kBQ, s.Cq) - 1;
  int k_hi = k_valid;
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
      Qs[d * kLd + rr] = qi < s.Cq ? to_f32(qg[qi * q_rs + d]) : 0.f;
    }
  }
  for (int k0 = 0; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's Ps/Vs reads are done
    for (int idx = tid; idx < kBK * HD; idx += kFwdThreads) {
      const int rr = idx / HD, d = idx % HD;
      const int kj = k0 + rr;
      const bool in = kj < s.Ck;
      Ks[d * kLd + rr] = in ? to_f32(kg[kj * kv_rs + d]) : 0.f;
      Vs[rr * HD + d] = in ? to_f32(vg[kj * kv_rs + d]) : 0.f;
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

template <typename T, int HD>
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
  int q_begin = 0;
  if (s.causal) q_begin = max(0, hop.k_start + k0 - hop.q_start);
  if (q_begin >= s.Cq) return;
  q_begin = (q_begin / kBQ) * kBQ;

  const long long q_row0 = ((long long)r * s.B + b) * s.Cq;
  const long long kv_row0 = ((long long)hop.src * s.B + b) * s.Ck;
  const long long q_rs = (long long)s.H * HD, kv_rs = (long long)s.Hk * HD;
  const T* kg = static_cast<const T*>(p.k) + (kv_row0 * s.Hk + kvh) * HD;
  const T* vg = static_cast<const T*>(p.v) + (kv_row0 * s.Hk + kvh) * HD;

  for (int idx = tid; idx < kBK * HD; idx += kBwdThreads) {
    const int rr = idx / HD, d = idx % HD;
    const int kj = k0 + rr;
    const bool in = kj < s.Ck;
    Ks[d * kLd + rr] = in ? to_f32(kg[kj * kv_rs + d]) : 0.f;
    Vs[d * kLd + rr] = in ? to_f32(vg[kj * kv_rs + d]) : 0.f;
  }

  float dk[4][kDC], dv[4][kDC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qg = static_cast<const T*>(p.q) + (q_row0 * s.H + h) * HD;
    const T* og = static_cast<const T*>(p.dout) + (q_row0 * s.H + h) * HD;
    const float* lg = p.lse + q_row0 * s.H + h;
    const float* dg = p.delta + q_row0 * s.H + h;
    float* dqg = p.dq + (q_row0 * s.H + h) * HD;
    for (int q0 = q_begin; q0 < s.Cq; q0 += kBQ) {
      __syncthreads();  // the previous tile's reads of every buffer are done
      for (int idx = tid; idx < kBQ * HD; idx += kBwdThreads) {
        const int rr = idx / HD, d = idx % HD;
        const int qi = q0 + rr;
        const bool in = qi < s.Cq;
        Qs[d * kLd + rr] = in ? to_f32(qg[qi * q_rs + d]) : 0.f;
        dOs[d * kLd + rr] = in ? to_f32(og[qi * q_rs + d]) : 0.f;
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
          const float pv = visible(s, hop, q0 + i, k0 + j, k_valid)
                               ? expf(sc[a][c] * s.sm_scale - lse_s[i])
                               : 0.f;
          Ps[i * kLd + j] = pv;
          dSs[i * kLd + j] = pv * (dp[a][c] - dl_s[i]);
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
          atomicAdd(dqg + qi * q_rs + tx + 16 * c, dqa[a][c] * s.sm_scale);
      }
    }
  }

  // this block alone owns these dK/dV rows within the launch
  float* dkg = p.dk + (kv_row0 * s.Hk + kvh) * HD;
  float* dvg = p.dv + (kv_row0 * s.Hk + kvh) * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= s.Ck) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const long long o = kj * kv_rs + tx + 16 * c;
      dkg[o] += dk[a][c] * s.sm_scale;
      dvg[o] += dv[a][c];
    }
  }
}

// ------------------------------------------------------------- launch ---
template <typename T, int HD>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      ring_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.s.Cq + kBQ - 1) / kBQ, p.s.H, p.s.R * p.s.B);
  ring_fwd_kernel<T, HD><<<grid, kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      ring_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.s.Ck + kBK - 1) / kBK, p.s.Hk, p.s.R * p.s.B);
  ring_bwd_kernel<T, HD><<<grid, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_fwd(const P& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_fwd<T, 16>(p, stream);
    case 32: return launch_fwd<T, 32>(p, stream);
    case 64: return launch_fwd<T, 64>(p, stream);
    case 128: return launch_fwd<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename P>
cudaError_t dispatch_bwd(const P& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(p, stream);
    case 32: return launch_bwd<T, 32>(p, stream);
    case 64: return launch_bwd<T, 64>(p, stream);
    case 128: return launch_bwd<T, 128>(p, stream);
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
    const Hop h{hops[4 * r], hops[4 * r + 1], hops[4 * r + 2],
                hops[4 * r + 3]};
    if (h.src < 0 || h.src >= Rk || h.k_valid < 0 || h.k_valid > Ck)
      return false;
    s->hops[r] = h;
  }
  return true;
}

}  // namespace

// One ring step for every rank: (m, l, acc)_out = fold(carry_in, hop).
// hops: R x (q_start, src, k_start, k_valid).
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
    case REPRO_F32: return dispatch_fwd<float>(p, hd, st);
    case REPRO_BF16: return dispatch_fwd<__nv_bfloat16>(p, hd, st);
    default: return cudaErrorInvalidValue;
  }
}

// One ring step's VJP for every rank, added into fp32 dq, dk, dv.  The
// hops' sources must be distinct (the wrapper checks).
extern "C" int ring_step_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int R, int Rk, int B, int Cq, int Ck, int H,
                             int Hk, int hd, const int* hops, int causal,
                             float sm_scale, int dtype, void* stream) {
  BwdParams p{q,
              k,
              v,
              dout,
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<float*>(dq),
              static_cast<float*>(dk),
              static_cast<float*>(dv),
              {}};
  if (!make_shape(&p.s, R, Rk, B, Cq, Ck, H, Hk, hops, causal, sm_scale))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return dispatch_bwd<float>(p, hd, st);
    case REPRO_BF16: return dispatch_bwd<__nv_bfloat16>(p, hd, st);
    default: return cudaErrorInvalidValue;
  }
}
