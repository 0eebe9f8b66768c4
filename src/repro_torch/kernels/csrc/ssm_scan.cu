// Mamba-1 selective scan (diagonal A) for Hopper.  Replaces the Pallas
// kernel repro/kernels/ssm_scan.py::ssm_scan (_kernel).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t      (di, ds) state
//   y_t = sum_n h_t[:, n] * C_t[n]
//
// fp32 throughout; u is read as bf16 or fp32 and upcast on load.  Returns y
// (B, S, di) and the last state h_S (B, di, ds), which the prefill keeps as
// the decode state, and on request (training) the state entering every
// kChunk-step chunk, which the VJP below (ssm_scan_bwd) starts from; a
// null pointer (serving) stores nothing.  No D skip and no gate: the
// caller adds them.
//
// What bounds it: each input byte is read once and each output written
// once (~83 MB at B1 S1000 di8192 ds16 with bf16 u: 0.025 ms at the H100
// SXM's data-sheet 3.35 TB/s, 700 W), but the B*S*di*ds exponentials (131 M
// there) are a higher floor on the special-function units (16 per SM per
// clock, 132 SMs at the 1.98 GHz boost clock: ~0.031 ms).
//
// Design.  On the TPU one grid cell keeps a (di_block, ds) state in VMEM
// and walks the chunks of S in order.  Here one thread owns kPer = 4
// states of one channel in registers for the whole sequence: kLanes = 4
// neighbouring lanes share a channel (states n = kPer * lane + j; states
// past ds carry zeros), kChannels = 32 channels a 128-thread block.  Each
// step a thread reads dt and u of its channel once (one product dt * u for
// its states) and B_t, C_t of its states as float4 broadcasts from shared
// memory, and keeps its part of y[t, d] in a register.  Steps go in groups
// of kLanes: after a group, kLanes - 1 shuffles leave lane q with the
// whole y of the group's step q, which it stores (3 shuffles for 4
// steps).  The block walks S in chunks of kChunk = 64 steps: dt, u, B and
// C of the next chunk are copied into the other half of a double buffer
// in shared memory (cp.async, 16 bytes a copy,
// when ds = 16, di is a multiple of kChannels and the bases are aligned;
// plain loads otherwise) while the current chunk's steps run.  Any S (the
// rows past S are zero-filled: dt = 0 leaves h as it is) and any di (a
// partial last block of channels is masked); 1 <= ds <= 16.  At the
// Mamba prefill (B 1, di 8192) that is 8 warps an SM: the kernel is bound
// by the latency of each step's loads, exponentials and sums, not by the
// special-function units (PERF.md).  S is not split across blocks: a
// chunked scan (each chunk's end state from zero, a carry pass, a rescan
// from the carried state) computes every decay twice, a floor of twice
// the one-pass bound on the special-function units.
//
// The decay is exp2(dt * A log2e) on the special-function unit (ex2.approx,
// A scaled by log2e once).  Its error grows with |dt * A| only where the
// decay is too small to add to h; the card tests hold it at the fp32
// tolerance from decays of 1 (dt and A near 0, 4096 steps) to underflow
// (|dt * A| >= 50).
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kStates = 16;                   // largest d_state taken
constexpr int kPer = 4;                       // states a thread owns
constexpr int kLanes = kStates / kPer;        // lanes a channel
constexpr int kChannels = 32;                 // channels a block
constexpr int kThreads = kLanes * kChannels;
constexpr int kChunk = 64;                    // time steps a chunk
constexpr float kLog2e = 1.4426950408889634f;

template <typename Tu>
struct Smem {
  float dt[2][kChunk][kChannels];
  Tu u[2][kChunk][kChannels];
  float b[2][kChunk][kStates];
  float c[2][kChunk][kStates];
};

// kVec: ds == 16, di % kChannels == 0 and 16-byte aligned bases, so each
// chunk row is whole 16-byte pieces for cp.async; kChunks: chunk_h is
// written (training), else the serving variant stores nothing more
template <typename Tu, bool kVec, bool kChunks>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const Tu* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ chunk_h,
                int S, int di, int ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<Tu>& sm = *reinterpret_cast<Smem<Tu>*>(smem_raw);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kLanes;                 // channel in the block
  const int q = tid % kLanes;                 // its lane in the channel
  const int d = d0 + c;
  const int n0 = q * kPer;                    // first state of the thread
  const int64_t row0 = (int64_t)b * S;        // first (b, t) row

  float a2[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool live = d < di && n0 + j < ds;
    a2[j] = live ? A[(int64_t)d * ds + n0 + j] * kLog2e : 0.f;
    h[j] = 0.f;
  }

  // chunk k's dt, u, B and C into buffer k & 1
  auto stage = [&](int k) {
    const int t0 = k * kChunk, buf = k & 1;
    if constexpr (kVec) {
      constexpr int kDt = kChannels / 4;              // 16 B pieces a row
      constexpr int kU = kChannels * sizeof(Tu) / 16;
      constexpr int kBC = kStates / 4;
#pragma unroll
      for (int i = tid; i < kChunk * kDt; i += kThreads) {
        const int tt = i / kDt, p = i % kDt;
        const bool in = t0 + tt < S;
        tc::cp_async16(&sm.dt[buf][tt][4 * p],
                       dt + (in ? (row0 + t0 + tt) * di + d0 : 0) + 4 * p,
                       in);
      }
#pragma unroll
      for (int i = tid; i < kChunk * kU; i += kThreads) {
        const int tt = i / kU, p = i % kU;
        constexpr int kE = 16 / sizeof(Tu);           // elements a piece
        const bool in = t0 + tt < S;
        tc::cp_async16(&sm.u[buf][tt][kE * p],
                       u + (in ? (row0 + t0 + tt) * di + d0 : 0) + kE * p,
                       in);
      }
#pragma unroll
      for (int i = tid; i < kChunk * kBC; i += kThreads) {
        const int tt = i / kBC, p = i % kBC;
        const bool in = t0 + tt < S;
        const int64_t off = (in ? (row0 + t0 + tt) * kStates : 0) + 4 * p;
        tc::cp_async16(&sm.b[buf][tt][4 * p], Bc + off, in);
        tc::cp_async16(&sm.c[buf][tt][4 * p], Cc + off, in);
      }
    } else {
      for (int i = tid; i < kChunk * kChannels; i += kThreads) {
        const int tt = i / kChannels, cc = i % kChannels;
        const bool in = t0 + tt < S && d0 + cc < di;
        const int64_t off = (row0 + t0 + tt) * di + d0 + cc;
        sm.dt[buf][tt][cc] = in ? dt[off] : 0.f;
        sm.u[buf][tt][cc] = in ? u[off] : from_f32<Tu>(0.f);
      }
      for (int i = tid; i < kChunk * kStates; i += kThreads) {
        const int tt = i / kStates, n = i % kStates;
        const bool in = t0 + tt < S && n < ds;
        const int64_t off = (row0 + t0 + tt) * ds + n;
        sm.b[buf][tt][n] = in ? Bc[off] : 0.f;
        sm.c[buf][tt][n] = in ? Cc[off] : 0.f;
      }
    }
    tc::cp_async_commit();
  };

  // one step of the thread's states from buffer buf, row t; returns
  // their part of y[t, d]
  auto step = [&](int buf, int t) {
    const float dtv = sm.dt[buf][t][c];
    const float du = dtv * to_f32(sm.u[buf][t][c]);
    const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][t][n0]);
    const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[buf][t][n0]);
    const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
    const float cv[kPer] = {c4.x, c4.y, c4.z, c4.w};
    float yp = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      h[j] = fmaf(tc::exp2_fast(dtv * a2[j]), h[j], du * bv[j]);
      yp = fmaf(h[j], cv[j], yp);
    }
    return yp;
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    tc::cp_async_wait<0>();  // chunk k has landed
    // every thread is past chunk k - 1: its buffer takes chunk k + 1
    __syncthreads();
    if (k + 1 < n_chunks) stage(k + 1);
    if constexpr (kChunks) {    // the state entering chunk k, for the VJP
      float* hc = chunk_h + (((int64_t)b * n_chunks + k) * di + d) * ds;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (d < di && n0 + j < ds) hc[n0 + j] = h[j];
    }
    const int t0 = k * kChunk, buf = k & 1;
    const int T = min(kChunk, S - t0);
    float* yg = y + (row0 + t0) * di + d;
    // every thread runs every step: the shuffles need all 32 lanes.
    // Steps in groups of kLanes: each lane sums its states' part of y for
    // every step of the group, then kLanes - 1 shuffles leave lane q with
    // the whole y of the group's step q.  Steps past T read zero-filled
    // rows (dt = 0: a decay of 1 and nothing added), so h passes them as
    // it is.
#pragma unroll 4
    for (int tt = 0; tt < T; tt += kLanes) {
      float v[kLanes];
#pragma unroll
      for (int g = 0; g < kLanes; ++g) v[g] = step(buf, tt + g);
      // halve the values a lane holds kLanes / 2, ..., 1 at a time: keep
      // the half its lane bit m names, add the partner's copy of it
#pragma unroll
      for (int m = kLanes / 2; m >= 1; m >>= 1) {
        const bool upper = q & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float send = upper ? v[i] : v[i + m];
          const float keep = upper ? v[i + m] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      if (d < di && tt + q < T) yg[(int64_t)(tt + q) * di] = v[0];
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (d < di && n0 + j < ds)
      h_last[((int64_t)b * di + d) * ds + n0 + j] = h[j];
}

template <typename Tu, bool kVec, bool kChunks>
cudaError_t launch_vec(const Tu* u, const float* dt, const float* Bc,
                       const float* Cc, const float* A, float* y,
                       float* h_last, float* chunk_h, int B, int S, int di,
                       int ds, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<Tu>);
  auto* kernel = ssm_scan_kernel<Tu, kVec, kChunks>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  kernel<<<grid, kThreads, smem, stream>>>(u, dt, Bc, Cc, A, y, h_last,
                                           chunk_h, S, di, ds);
  return cudaGetLastError();
}

template <typename Tu>
cudaError_t launch(const void* u, const float* dt, const float* Bc,
                   const float* Cc, const float* A, float* y, float* h_last,
                   float* chunk_h, int B, int S, int di, int ds,
                   cudaStream_t stream) {
  const Tu* up = static_cast<const Tu*>(u);
  const bool vec = ds == kStates && di % kChannels == 0 && aligned16(u) &&
                   aligned16(dt) && aligned16(Bc) && aligned16(Cc);
  if (chunk_h != nullptr)
    return vec ? launch_vec<Tu, true, true>(up, dt, Bc, Cc, A, y, h_last,
                                            chunk_h, B, S, di, ds, stream)
               : launch_vec<Tu, false, true>(up, dt, Bc, Cc, A, y, h_last,
                                             chunk_h, B, S, di, ds, stream);
  return vec ? launch_vec<Tu, true, false>(up, dt, Bc, Cc, A, y, h_last,
                                           chunk_h, B, S, di, ds, stream)
             : launch_vec<Tu, false, false>(up, dt, Bc, Cc, A, y, h_last,
                                            chunk_h, B, S, di, ds, stream);
}

template <typename Tu>
cudaError_t attrs(int* out) {
  constexpr size_t smem = sizeof(Smem<Tu>);
  auto* kernel = ssm_scan_kernel<Tu, true, false>;
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

// ------------------------------------------------------------- the VJP ---
// ssm_scan_bwd: given dy = dL/dy (B, S, di) fp32, the gradients of u, dt,
// Bc, Cc and A.  With g_t = dL/dh_t (no gradient reaches the last state):
//
//   g_t   = dy_t C_t + exp(dt_{t+1} A) g_{t+1}
//   du_t  = sum_n g_t dt_t B_t             ddt_t = sum_n g_t (u_t B_t + A a_t h_{t-1})
//   dB_t  = sum_d g_t dt_t u_t             dC_t  = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}        (a_t = exp(dt_t A))
//
// The forward stored the state entering every kChunk-step chunk.  The
// block (the forward's layout: 4 states of a channel a thread, 4 lanes a
// channel, 32 channels) walks the chunks in reverse.  For each it
// recomputes the chunk's states from the stored start with the forward's
// own arithmetic (the same h bit for bit), keeping each thread's 4
// states of every step in shared memory (128 KB), then walks the steps
// backwards carrying a_{t+1} g_{t+1} in registers across chunks: one
// exponential a state a step in each walk.  The state is never run
// backwards (h_{t-1} = (h_t - dt u B) / a_t is lost where a underflows).
//
// Sums: du and ddt over a channel's 4 lanes, 4 steps a group with 3
// shuffles each, as y in the forward; dB and dC over the warp's 8
// channels with 7 shuffles a step (each lane left with one of the 8
// sums), then over the block's 4 warps in shared memory in a fixed order
// into a partial of the block; a second kernel adds the blocks' partials
// in block order, and dA's partials (one a batch row) in row order.  No
// float atomics: two runs of one input give the same bits.
constexpr int kWarps = kThreads / 32;
constexpr int kRedVals = 2 * kPer;            // dB and dC of 4 states
constexpr int kWarpChannels = 32 / kLanes;    // channels a warp

template <typename Tu>
struct BwdSmem {
  float4 h[kChunk][kThreads];       // h_t of each thread's 4 states
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  Tu u[kChunk][kChannels];
  float b[kChunk][kStates];
  float c[kChunk][kStates];
  float red[kWarps][kChunk][32];    // a warp's 8-channel sums, a step
};

template <typename Tu>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const Tu* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ Bc,
                    const float* __restrict__ Cc,
                    const float* __restrict__ A,
                    const float* __restrict__ chunk_h,
                    const float* __restrict__ dy, Tu* __restrict__ du,
                    float* __restrict__ ddt, float* __restrict__ part_b,
                    float* __restrict__ part_c, float* __restrict__ part_a,
                    int S, int di, int ds) {
  static_assert(kWarpChannels == kRedVals, "one sum a lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<Tu>& sm = *reinterpret_cast<BwdSmem<Tu>*>(smem_raw);

  const int b = blockIdx.y, blk = blockIdx.x, Bsz = gridDim.y;
  const int d0 = blk * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kLanes, q = tid % kLanes;
  const int d = d0 + c, n0 = q * kPer;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)b * S;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  float a[kPer], a2[kPer], carry[kPer], da[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool live = d < di && n0 + j < ds;
    a[j] = live ? A[(int64_t)d * ds + n0 + j] : 0.f;
    a2[j] = a[j] * kLog2e;
    carry[j] = 0.f;          // a_{t+1} g_{t+1}: nothing after the last step
    da[j] = 0.f;
  }

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int T = min(kChunk, S - t0);
    const int Tp = (T + kLanes - 1) / kLanes * kLanes;   // whole groups
    __syncthreads();         // every thread is done with the last chunk's
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      const bool in = tt < T && d0 + cc < di;
      const int64_t off = (row0 + t0 + tt) * di + d0 + cc;
      sm.dt[tt][cc] = in ? dt[off] : 0.f;
      sm.dy[tt][cc] = in ? dy[off] : 0.f;
      sm.u[tt][cc] = in ? u[off] : from_f32<Tu>(0.f);
    }
    for (int i = tid; i < kChunk * kStates; i += kThreads) {
      const int tt = i / kStates, n = i % kStates;
      const bool in = tt < T && n < ds;
      const int64_t off = (row0 + t0 + tt) * ds + n;
      sm.b[tt][n] = in ? Bc[off] : 0.f;
      sm.c[tt][n] = in ? Cc[off] : 0.f;
    }
    float h0[kPer];          // the state entering the chunk
    const float* hc = chunk_h + (((int64_t)b * n_chunks + k) * di + d) * ds;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      h0[j] = d < di && n0 + j < ds ? hc[n0 + j] : 0.f;
    __syncthreads();

    // the chunk's states, as the forward computed them; rows past T are
    // zero-filled (dt = 0) and leave h as it is
    {
      float h[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[j] = h0[j];
      for (int t = 0; t < Tp; ++t) {
        const float dtv = sm.dt[t][c];
        const float dus = dtv * to_f32(sm.u[t][c]);
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[t][n0]);
        const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          h[j] = fmaf(tc::exp2_fast(dtv * a2[j]), h[j], dus * bv[j]);
        sm.h[t][tid] = make_float4(h[0], h[1], h[2], h[3]);
      }
    }

    // the reverse walk, kLanes steps a group.  Padded rows come only in
    // the last chunk, which is walked first: g is 0 through them
    for (int tt = Tp - kLanes; tt >= 0; tt -= kLanes) {
      float vdu[kLanes], vdt[kLanes];
#pragma unroll
      for (int gi = kLanes - 1; gi >= 0; --gi) {
        const int t = tt + gi;
        const float dtv = sm.dt[t][c];
        const float uv = to_f32(sm.u[t][c]);
        const float dyv = sm.dy[t][c];
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[t][n0]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[t][n0]);
        const float4 h4 = sm.h[t][tid];
        const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[kPer] = {c4.x, c4.y, c4.z, c4.w};
        const float hv[kPer] = {h4.x, h4.y, h4.z, h4.w};
        float hp[kPer];
        if (t > 0) {
          const float4 p4 = sm.h[t - 1][tid];
          hp[0] = p4.x; hp[1] = p4.y; hp[2] = p4.z; hp[3] = p4.w;
        } else {
#pragma unroll
          for (int j = 0; j < kPer; ++j) hp[j] = h0[j];
        }
        float pdu = 0.f, pdt = 0.f, r[kRedVals];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float dec = tc::exp2_fast(dtv * a2[j]);
          const float g = fmaf(dyv, cv[j], carry[j]);
          const float gdt = g * dtv;
          const float dh = dec * hp[j];
          pdu = fmaf(gdt, bv[j], pdu);
          pdt = fmaf(g, fmaf(uv, bv[j], a[j] * dh), pdt);
          da[j] = fmaf(gdt, dh, da[j]);
          r[j] = gdt * uv;              // dB of state n0 + j
          r[kPer + j] = dyv * hv[j];    // dC of state n0 + j
          carry[j] = dec * g;
        }
        vdu[gi] = pdu;
        vdt[gi] = pdt;
        // over the warp's 8 channels (lane bits 2-4): halve the values a
        // lane holds at each bit, leaving lane (cw, q) with the sum of
        // value cw (cw = lane >> 2)
#pragma unroll
        for (int rd = 0; rd < 3; ++rd) {
          const int m = 16 >> rd, half = (kRedVals / 2) >> rd;
          const bool upper = lane & m;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = upper ? r[i] : r[i + half];
            const float keep = upper ? r[i + half] : r[i];
            r[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        }
        sm.red[warp][t][lane] = r[0];
      }
      // du and ddt over the channel's lanes: lane q keeps step tt + q
#pragma unroll
      for (int m = kLanes / 2; m >= 1; m >>= 1) {
        const bool upper = q & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float s1 = upper ? vdu[i] : vdu[i + m];
          const float k1 = upper ? vdu[i + m] : vdu[i];
          vdu[i] = k1 + __shfl_xor_sync(0xffffffffu, s1, m);
          const float s2 = upper ? vdt[i] : vdt[i + m];
          const float k2 = upper ? vdt[i + m] : vdt[i];
          vdt[i] = k2 + __shfl_xor_sync(0xffffffffu, s2, m);
        }
      }
      if (d < di && tt + q < T) {
        const int64_t off = (row0 + t0 + tt + q) * di + d;
        du[off] = from_f32<Tu>(vdu[0]);
        ddt[off] = vdt[0];
      }
    }
    __syncthreads();
    // the block's partial dB and dC of the chunk: the warps in order
    for (int i = tid; i < T * 32; i += kThreads) {
      const int t = i / 32, l = i % 32;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm.red[w][t][l];
      const int cw = l / kLanes, n = kPer * (l % kLanes) + cw % kPer;
      if (n < ds) {
        float* part = cw < kPer ? part_b : part_c;
        part[(((int64_t)blk * Bsz + b) * S + t0 + t) * ds + n] = sum;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (d < di && n0 + j < ds)
      part_a[((int64_t)b * di + d) * ds + n0 + j] = da[j];
}

// out[i] = sum over p = 0, 1, ..., P - 1 of part[p][i], in that order
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int P,
                                    int64_t N) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < N;
       i += (int64_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int p = 0; p < P; ++p) sum += part[(int64_t)p * N + i];
    out[i] = sum;
  }
}

cudaError_t sum_partials(const float* part, float* out, int P, int64_t N,
                         cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = std::min<int64_t>((N + threads - 1) / threads,
                                           65535);
  sum_partials_kernel<<<(int)blocks, threads, 0, stream>>>(part, out, P, N);
  return cudaGetLastError();
}

template <typename Tu>
cudaError_t launch_bwd(const void* u, const float* dt, const float* Bc,
                       const float* Cc, const float* A, const float* chunk_h,
                       const float* dy, void* du, float* ddt, float* dB,
                       float* dC, float* dA, float* part_b, float* part_c,
                       float* part_a, int B, int S, int di, int ds,
                       cudaStream_t stream) {
  constexpr size_t smem = sizeof(BwdSmem<Tu>);
  auto* kernel = ssm_scan_bwd_kernel<Tu>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tu*>(u), dt, Bc, Cc, A, chunk_h, dy,
      static_cast<Tu*>(du), ddt, part_b, part_c, part_a, S, di, ds);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t n_bc = (int64_t)B * S * ds;
  if ((e = sum_partials(part_b, dB, grid.x, n_bc, stream)) != cudaSuccess)
    return e;
  if ((e = sum_partials(part_c, dC, grid.x, n_bc, stream)) != cudaSuccess)
    return e;
  return sum_partials(part_a, dA, B, (int64_t)di * ds, stream);
}

template <typename Tu>
cudaError_t bwd_attrs(int* out) {
  constexpr size_t smem = sizeof(BwdSmem<Tu>);
  auto* kernel = ssm_scan_bwd_kernel<Tu>;
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

}  // namespace

// u: (B, S, di) of u_dtype; dt: (B, S, di); Bc, Cc: (B, S, ds); A: (di, ds)
// -> y: (B, S, di), h_last: (B, di, ds), and when chunk_h is not null the
// state entering every kChunk-step chunk, (B, ceil(S / kChunk), di, ds).
// All contiguous; all but u fp32.
extern "C" int ssm_scan_fwd(const void* u, const void* dt, const void* Bc,
                            const void* Cc, const void* A, void* y,
                            void* h_last, void* chunk_h, int B, int S,
                            int di, int ds, int u_dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || ds <= 0 || ds > kStates)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* bp = static_cast<const float*>(Bc);
  const float* cp = static_cast<const float*>(Cc);
  const float* ap = static_cast<const float*>(A);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(h_last);
  float* hc = static_cast<float*>(chunk_h);
  switch (u_dtype) {
    case REPRO_F32:
      return launch<float>(u, dtp, bp, cp, ap, yp, hp, hc, B, S, di, ds, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(u, dtp, bp, cp, ap, yp, hp, hc, B, S, di,
                                   ds, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The scan's registers, spill bytes, dynamic shared memory and resident
// blocks per SM (the cp.async kernel, as the prefill launches it) for u
// of dtype code u_dtype, into out[0..3].
extern "C" int ssm_scan_attrs(int u_dtype, int* out) {
  switch (u_dtype) {
    case REPRO_F32: return attrs<float>(out);
    case REPRO_BF16: return attrs<__nv_bfloat16>(out);
    default: return cudaErrorInvalidValue;
  }
}

// The VJP of ssm_scan_fwd.  u, dt, Bc, Cc, A as there; chunk_h the states
// ssm_scan_fwd stored, (B, ceil(S / kChunk), di, ds); dy (B, S, di) fp32
// -> du (B, S, di) of u_dtype, ddt (B, S, di), dB, dC (B, S, ds), dA
// (di, ds), all fp32 but du.  part_b and part_c (ceil(di / 32), B, S, ds)
// and part_a (B, di, ds) are fp32 scratch for the blocks' partial sums.
// All contiguous.  Four launches on the stream, in order.
extern "C" int ssm_scan_bwd(const void* u, const void* dt, const void* Bc,
                            const void* Cc, const void* A,
                            const void* chunk_h, const void* dy, void* du,
                            void* ddt, void* dB, void* dC, void* dA,
                            void* part_b, void* part_c, void* part_a, int B,
                            int S, int di, int ds, int u_dtype,
                            void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || ds <= 0 || ds > kStates)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  switch (u_dtype) {
    case REPRO_F32:
      return launch_bwd<float>(u, f(dt), f(Bc), f(Cc), f(A), f(chunk_h),
                               f(dy), du, w(ddt), w(dB), w(dC), w(dA),
                               w(part_b), w(part_c), w(part_a), B, S, di, ds,
                               s);
    case REPRO_BF16:
      return launch_bwd<__nv_bfloat16>(u, f(dt), f(Bc), f(Cc), f(A),
                                       f(chunk_h), f(dy), du, w(ddt), w(dB),
                                       w(dC), w(dA), w(part_b), w(part_c),
                                       w(part_a), B, S, di, ds, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward kernel's registers, spill bytes, dynamic shared memory and
// resident blocks per SM for u of dtype code u_dtype, into out[0..3].
extern "C" int ssm_scan_bwd_attrs(int u_dtype, int* out) {
  switch (u_dtype) {
    case REPRO_F32: return bwd_attrs<float>(out);
    case REPRO_BF16: return bwd_attrs<__nv_bfloat16>(out);
    default: return cudaErrorInvalidValue;
  }
}
