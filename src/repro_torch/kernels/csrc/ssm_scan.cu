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
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;

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
// Bc, Cc and A.  With a_t = exp(dt_t A) and g_t = dL/dh_t (no gradient
// reaches the last state):
//
//   g_t   = dy_t C_t + a_{t+1} g_{t+1}
//   du_t  = dt_t s1_t                ddt_t = u_t s1_t + s2_t
//     with s1_t = sum_n g_t B_t and s2_t = sum_n g_t A a_t h_{t-1}
//   dB_t  = sum_d g_t dt_t u_t       dC_t  = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}
//
// Time is split over blocks.  The forward stored the state entering every
// kChunk-step chunk, so chunk k's states need only that state.  The one
// serial link is the reverse carry c = a_{t+1} g_{t+1}, and it is linear:
// a stretch of steps that receives the carry c passes on L + Q c, where Q
// is the product of its decays and L = sum_t (a_t0 ... a_t) dy_t C_t its
// carry from a zero start.  One block takes one (chunk, 32 channels, batch
// row) in the forward's layout (4 states of a channel a thread, 4 lanes a
// channel), 128 threads, and:
//   1. copies the chunk's dt, dy, u, B and C into shared memory with
//      cp.async, in two halves, and starts on the first half while the
//      second lands;
//   2. takes L_j and the dt sum of each kSub-step sub-chunk j, a walk
//      that needs no state: a_tj ... a_t = exp2(A log2e (dt_tj + ... +
//      dt_t)), and Q_j that of the whole sum;
//   3. waits for c_k from the block of chunk k + 1 (an integer flag,
//      acquire/release), composes the sub-chunks' (L_j, Q_j) back from
//      c_k into the carry entering each sub-chunk, and passes chunk k's
//      carry on to chunk k - 1;
//   4. takes the sub-chunks in order, the state carried from the chunk's
//      stored start: recomputes a sub-chunk's states and decays into
//      registers with the forward's own arithmetic (the same h bit for
//      bit), then walks its steps backwards from its carry, reusing those
//      decays.
// Blocks take their work from a ticket (an integer atomic) in order of
// chunks from the last, so a block only ever waits for a block that got
// its ticket earlier and is running: no deadlock whatever the order the
// card starts blocks in.  At falcon-mamba-7b's shape (B1 S4096 di8192)
// that is 16,384 blocks of 4 warps with 55 KB of shared memory (bf16 u),
// 4 blocks an SM, where one block a channel group had 256 blocks at one
// an SM.
//
// Sums, each in a fixed order (no float atomics: two runs of one input
// give the same bits): du and ddt over a channel's 4 lanes, 4 steps a
// group with 3 shuffles each, as y in the forward; dB and dC over the
// warp's 8 channels with 7 shuffles a step, the 4 steps of a group side
// by side so that their shuffles overlap, over the block's 4 warps in
// shared memory in warp order, then over a cluster of kCluster blocks (256
// channels) through distributed shared memory in rank order into one
// partial a cluster, which a second kernel adds in cluster order (32
// partials at di 8192: 16.8 MB written and read, an eighth of what 256
// per-block partials took); dA along the chunks' chain (each
// block adds its own to the running sum of the chunks after it, behind
// a second flag) into one partial a batch row, added in row order.
//
// What bounds it on the H100 SXM (700 W): the bytes are u, dt, dy, B, C,
// A and the chunk states read once, du, ddt, dB, dC and dA written once,
// 571 MB at falcon's shape (0.171 ms at the data sheet's 3.35 TB/s), and
// the partials 34 MB more.  Each state and step takes two exponentials,
// one in step 2 and one in the sub-chunk's recompute (the reverse walk
// reuses the recompute's), 1.07 G on the special-function units (16 an SM
// a clock, 132 SMs at 1.98 GHz): 0.257 ms.  Above both, the instructions
// bind: ~35 a state and step (the walks' arithmetic, the shuffles and
// selects of the per-step sums), 0.57 ms at one a clock per scheduler,
// and 16 warps an SM (registers cap them) do not hide all the latency.
// Tensor cores do not apply: each step's sums over d (dB, dC) and over n
// (du, ddt) are matrix-vector products with a new matrix every step.  The
// state is never run backwards (h_{t-1} = (h_t - dt u B) / a_t is lost
// where a underflows).
constexpr int kWarps = kThreads / 32;
constexpr int kRedVals = 2 * kPer;            // dB and dC of 4 states
constexpr int kWarpChannels = 32 / kLanes;    // channels a warp
constexpr int kSub = 8;                       // steps a sub-chunk
constexpr int kSubs = kChunk / kSub;          // sub-chunks a chunk
constexpr int kCluster = 8;                   // blocks a cluster
constexpr int kRankSteps = kChunk / kCluster; // steps a rank sums
static_assert(kSub * 32 % kThreads == 0 && kRankSteps * 32 % kThreads == 0,
              "whole rounds of the block's threads");

template <typename Tu>
struct BwdSmem {
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  Tu u[kChunk][kChannels];
  float b[kChunk][kStates];
  float c[kChunk][kStates];
  float4 lc[kSubs - 1][kThreads];   // L_j of sub-chunks 1 .., then the
                                    // carries entering sub-chunks 0 ..
  union {
    float sdt[kSubs][kThreads];     // a sub-chunk's dt sum (steps 2-3)
    float red[kWarps][kSub][32];    // a warp's 8-channel sums, a step
  };
  float bsum[kChunk][32];           // the block's dB and dC sums, a step
  int ticket;                       // the cluster's, in rank 0
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// thread 0 waits until *flag >= want, then the block goes on.  A chain
// that never arrives is a fault: trap after ~2^26 polls (seconds) rather
// than hang the card.
__device__ __forceinline__ void wait_flag(const int* flag, int want) {
  if (threadIdx.x == 0) {
    for (unsigned polls = 0; ld_acquire(flag) < want; ++polls) {
      if (polls >= (1u << 26)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// kVec: ds == 16, di % kChannels == 0 and 16-byte aligned bases (cp.async
// of whole 16-byte pieces); else plain loads.  flags: [0] the tickets,
// then the carry's and dA's flags, each (B, n_cl * kCluster): how many
// chunks of that batch row and channel group have passed theirs on.
template <typename Tu, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
ssm_scan_bwd_kernel(const Tu* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ Bc,
                    const float* __restrict__ Cc,
                    const float* __restrict__ A,
                    const float* __restrict__ chunk_h,
                    const float* __restrict__ dy, Tu* __restrict__ du,
                    float* __restrict__ ddt, float* __restrict__ part_b,
                    float* __restrict__ part_c, float* __restrict__ part_a,
                    float* __restrict__ carry_buf, int* __restrict__ flags,
                    int Bsz, int S, int di, int ds, int n_cl) {
  static_assert(kWarpChannels == kRedVals, "one sum a lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<Tu>& sm = *reinterpret_cast<BwdSmem<Tu>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;

  if (rank == 0 && tid == 0) sm.ticket = atomicAdd(flags, 1);
  cluster.sync();
  const int ticket = *cluster.map_shared_rank(&sm.ticket, 0);
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int per_chunk = n_cl * Bsz;
  const int k = n_chunks - 1 - ticket / per_chunk;   // the last chunk first
  const int b = ticket % per_chunk / n_cl, cl = ticket % n_cl;
  const int grp = cl * kCluster + rank, n_gp = n_cl * kCluster;
  const int d0 = grp * kChannels;
  const int c = tid / kLanes, q = tid % kLanes;
  const int d = d0 + c, n0 = q * kPer;
  const int lane = tid & 31, warp = tid >> 5;
  const int t0 = k * kChunk;
  const int64_t row0 = (int64_t)b * S;

  // step 1: the chunk into shared memory, rows past S zero-filled (dt = 0
  // and dy = 0: a decay of 1, nothing added, g unchanged)
  auto stage = [&](int half) {
    constexpr int kRows = kChunk / 2;
    const int tb = half * kRows;
    if constexpr (kVec) {
      constexpr int kDt = kChannels / 4;              // 16 B pieces a row
      constexpr int kU = kChannels * sizeof(Tu) / 16;
      constexpr int kE = 16 / sizeof(Tu);             // u elements a piece
      constexpr int kBC = kStates / 4;
      const bool live = d0 < di;
      for (int i = tid; i < kRows * kDt; i += kThreads) {
        const int tt = tb + i / kDt, p = i % kDt;
        const bool in = live && t0 + tt < S;
        const int64_t off = (in ? (row0 + t0 + tt) * di + d0 : 0) + 4 * p;
        tc::cp_async16(&sm.dt[tt][4 * p], dt + off, in);
        tc::cp_async16(&sm.dy[tt][4 * p], dy + off, in);
      }
      for (int i = tid; i < kRows * kU; i += kThreads) {
        const int tt = tb + i / kU, p = i % kU;
        const bool in = live && t0 + tt < S;
        tc::cp_async16(&sm.u[tt][kE * p],
                       u + (in ? (row0 + t0 + tt) * di + d0 : 0) + kE * p,
                       in);
      }
      for (int i = tid; i < kRows * kBC; i += kThreads) {
        const int tt = tb + i / kBC, p = i % kBC;
        const bool in = t0 + tt < S;
        const int64_t off = (in ? (row0 + t0 + tt) * kStates : 0) + 4 * p;
        tc::cp_async16(&sm.b[tt][4 * p], Bc + off, in);
        tc::cp_async16(&sm.c[tt][4 * p], Cc + off, in);
      }
    } else {
      for (int i = tid; i < kRows * kChannels; i += kThreads) {
        const int tt = tb + i / kChannels, cc = i % kChannels;
        const bool in = t0 + tt < S && d0 + cc < di;
        const int64_t off = (row0 + t0 + tt) * di + d0 + cc;
        sm.dt[tt][cc] = in ? dt[off] : 0.f;
        sm.dy[tt][cc] = in ? dy[off] : 0.f;
        sm.u[tt][cc] = in ? u[off] : from_f32<Tu>(0.f);
      }
      for (int i = tid; i < kRows * kStates; i += kThreads) {
        const int tt = tb + i / kStates, n = i % kStates;
        const bool in = t0 + tt < S && n < ds;
        const int64_t off = (row0 + t0 + tt) * ds + n;
        sm.b[tt][n] = in ? Bc[off] : 0.f;
        sm.c[tt][n] = in ? Cc[off] : 0.f;
      }
    }
    tc::cp_async_commit();
  };
  stage(0);
  stage(1);

  bool live[kPer];
  float a[kPer], a2[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    live[j] = d < di && n0 + j < ds;
    a[j] = live[j] ? A[(int64_t)d * ds + n0 + j] : 0.f;
    a2[j] = a[j] * kLog2e;
  }

  // step 2: each sub-chunk's carry from a zero start, L_j = sum_t (a_tj
  // ... a_t) dy_t C_t (L_0 in registers, L_1 .. in sm.lc), and its dt sum,
  // whose exp2(A log2e sum) is Q_j, the product of its decays
  float L0[kPer];
  tc::cp_async_wait<1>();   // the first half has landed
  __syncthreads();
#pragma unroll 1
  for (int sb = 0; sb < kSubs; ++sb) {
    if (sb == kSubs / 2) {
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    // a_tj ... a_t = exp2(A log2e (dt_tj + ... + dt_t)): one exponential
    // a state and step, no product carried from step to step
    float L[kPer], sdt = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) L[j] = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int t = sb * kSub + s;
      const float dyv = sm.dy[t][c];
      const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[t][n0]);
      const float cv[kPer] = {c4.x, c4.y, c4.z, c4.w};
      sdt += sm.dt[t][c];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        L[j] = fmaf(tc::exp2_fast(sdt * a2[j]), dyv * cv[j], L[j]);
    }
    sm.sdt[sb][tid] = sdt;
    if (sb == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) L0[j] = L[j];
    } else {
      sm.lc[sb - 1][tid] = make_float4(L[0], L[1], L[2], L[3]);
    }
  }

  // step 3: the carry c_k from chunk k + 1 (zero past the last step);
  // then, from the last sub-chunk back, the carry entering each
  // sub-chunk's last step (over L_j in sm.lc), and chunk k's carry on to
  // chunk k - 1, in place
  float c_last[kPer];   // the carry entering the last sub-chunk: c_k
  int* cflag = flags + 1 + (int64_t)b * n_gp + grp;
  int* aflag = cflag + (int64_t)Bsz * n_gp;
  float* cb = carry_buf + ((int64_t)b * di + d) * ds + n0;
  if (k + 1 < n_chunks) {
    wait_flag(cflag, n_chunks - 1 - k);
#pragma unroll
    for (int j = 0; j < kPer; ++j) c_last[j] = live[j] ? __ldcg(cb + j) : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) c_last[j] = 0.f;
  }
  {
    float cur[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) cur[j] = c_last[j];
#pragma unroll 1
    for (int sb = kSubs - 1; sb >= 1; --sb) {
      const float4 l4 = sm.lc[sb - 1][tid];
      const float lv[kPer] = {l4.x, l4.y, l4.z, l4.w};
      const float sd = sm.sdt[sb][tid];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        cur[j] = fmaf(tc::exp2_fast(sd * a2[j]), cur[j], lv[j]);
      sm.lc[sb - 1][tid] = make_float4(cur[0], cur[1], cur[2], cur[3]);
    }
    if (k > 0) {
      const float sd = sm.sdt[0][tid];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (live[j])
          __stcg(cb + j, fmaf(tc::exp2_fast(sd * a2[j]), cur[j], L0[j]));
      __threadfence();
    }
    __syncthreads();   // the stores above; sm.sdt is done (red reuses it)
    if (k > 0 && tid == 0) st_release(cflag, n_chunks - k);
  }

  // step 4: the sub-chunks in order, the state carried from the chunk's
  // stored start: recompute a sub-chunk's states and decays into
  // registers, then walk its steps backwards from its carry
  float h[kPer], da[kPer];
  {
    const float* hc = chunk_h + (((int64_t)b * n_chunks + k) * di + d) * ds;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      h[j] = live[j] ? hc[n0 + j] : 0.f;
      da[j] = 0.f;
    }
  }
#pragma unroll 1
  for (int sb = 0; sb < kSubs; ++sb) {
    float hs[kSub + 1][kPer], dec[kSub][kPer];   // hs[s + 1] = h at step s
    float carry[kPer];
    if (sb + 1 < kSubs) {
      const float4 v = sm.lc[sb][tid];
      carry[0] = v.x; carry[1] = v.y; carry[2] = v.z; carry[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) carry[j] = c_last[j];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) hs[0][j] = h[j];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int t = sb * kSub + s;
      const float dtv = sm.dt[t][c];
      const float dus = dtv * to_f32(sm.u[t][c]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[t][n0]);
      const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        dec[s][j] = tc::exp2_fast(dtv * a2[j]);
        hs[s + 1][j] = fmaf(dec[s][j], hs[s][j], dus * bv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) h[j] = hs[kSub][j];
    // backwards, kLanes steps a group
#pragma unroll
    for (int grp4 = kSub / kLanes - 1; grp4 >= 0; --grp4) {
      float v1[kLanes], v2[kLanes], r[kLanes][kRedVals];
#pragma unroll
      for (int gi = kLanes - 1; gi >= 0; --gi) {
        const int s = grp4 * kLanes + gi, t = sb * kSub + s;
        const float dtv = sm.dt[t][c];
        const float uv = to_f32(sm.u[t][c]);
        const float dyv = sm.dy[t][c];
        const float dtu = dtv * uv;
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[t][n0]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[t][n0]);
        const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[kPer] = {c4.x, c4.y, c4.z, c4.w};
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float g = fmaf(dyv, cv[j], carry[j]);
          const float gh = g * (dec[s][j] * hs[s][j]);
          s1 = fmaf(g, bv[j], s1);
          s2 = fmaf(gh, a[j], s2);
          da[j] = fmaf(gh, dtv, da[j]);
          r[gi][j] = g * dtu;                    // dB of state n0 + j
          r[gi][kPer + j] = dyv * hs[s + 1][j];  // dC of state n0 + j
          carry[j] = dec[s][j] * g;
        }
        v1[gi] = s1;
        v2[gi] = s2;
      }
      // dB and dC over the warp's 8 channels (lane bits 2-4), the group's
      // steps side by side: halve the values a lane holds at each bit,
      // leaving lane (cw, q) with the sum of value cw (cw = lane >> 2)
#pragma unroll
      for (int rd = 0; rd < 3; ++rd) {
        const int m = 16 >> rd, half = (kRedVals / 2) >> rd;
        const bool upper = lane & m;
#pragma unroll
        for (int gi = 0; gi < kLanes; ++gi) {
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = upper ? r[gi][i] : r[gi][i + half];
            const float keep = upper ? r[gi][i + half] : r[gi][i];
            r[gi][i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kLanes; ++gi)
        sm.red[warp][grp4 * kLanes + gi][lane] = r[gi][0];
      // s1 and s2 over the channel's lanes: lane q keeps step grp4 * 4 + q
#pragma unroll
      for (int m = kLanes / 2; m >= 1; m >>= 1) {
        const bool upper = q & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float x1 = upper ? v1[i] : v1[i + m];
          const float k1 = upper ? v1[i + m] : v1[i];
          v1[i] = k1 + __shfl_xor_sync(0xffffffffu, x1, m);
          const float x2 = upper ? v2[i] : v2[i + m];
          const float k2 = upper ? v2[i + m] : v2[i];
          v2[i] = k2 + __shfl_xor_sync(0xffffffffu, x2, m);
        }
      }
      const int t = sb * kSub + grp4 * kLanes + q;
      if (d < di && t0 + t < S) {
        const int64_t off = (row0 + t0 + t) * di + d;
        du[off] = from_f32<Tu>(sm.dt[t][c] * v1[0]);
        ddt[off] = fmaf(to_f32(sm.u[t][c]), v1[0], v2[0]);
      }
    }
    __syncthreads();
    // the block's dB and dC of the sub-chunk: the warps in order
#pragma unroll
    for (int it = 0; it < kSub * 32 / kThreads; ++it) {
      const int i = tid + it * kThreads, s = i / 32, l = i % 32;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm.red[w][s][l];
      sm.bsum[sb * kSub + s][l] = sum;
    }
    __syncthreads();
  }

  // the cluster's dB and dC: rank r adds its kRankSteps steps of the
  // kCluster blocks' sums, in rank order, into the cluster's partial
  cluster.sync();
#pragma unroll
  for (int it = 0; it < kRankSteps * 32 / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int t = rank * kRankSteps + i / 32, l = i % 32;
    float sum = 0.f;
#pragma unroll
    for (int rr = 0; rr < kCluster; ++rr)
      sum += cluster.map_shared_rank(&sm.bsum[0][0], rr)[t * 32 + l];
    const int cw = l / kLanes, n = kPer * (l % kLanes) + cw % kPer;
    if (n < ds && t0 + t < S) {
      float* part = cw < kPer ? part_b : part_c;
      part[(((int64_t)cl * Bsz + b) * S + t0 + t) * ds + n] = sum;
    }
  }
  cluster.sync();   // no block leaves while another reads its sums

  // dA: the running sum of the chunks after this one, then this chunk's
  float* pa = part_a + ((int64_t)b * di + d) * ds + n0;
  if (k + 1 < n_chunks) {
    wait_flag(aflag, n_chunks - 1 - k);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (live[j]) da[j] = __ldcg(pa + j) + da[j];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (live[j]) __stcg(pa + j, da[j]);
  if (k > 0) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(aflag, n_chunks - k);
  }
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

// the clusters a call's channels take, and the flag words it needs
inline int bwd_clusters(int di) {
  return (di + kChannels * kCluster - 1) / (kChannels * kCluster);
}

template <typename Tu, bool kVec>
cudaError_t set_bwd_smem() {
  constexpr int smem = (int)sizeof(BwdSmem<Tu>);
  auto* kernel = ssm_scan_bwd_kernel<Tu, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  return e;
}

template <typename Tu, bool kVec>
cudaError_t launch_bwd_vec(const Tu* u, const float* dt, const float* Bc,
                           const float* Cc, const float* A,
                           const float* chunk_h, const float* dy, Tu* du,
                           float* ddt, float* part_b, float* part_c,
                           float* part_a, float* carry, int* flags, int B,
                           int S, int di, int ds, cudaStream_t stream) {
  cudaError_t e = set_bwd_smem<Tu, kVec>();
  if (e != cudaSuccess) return e;
  const int n_cl = bwd_clusters(di);
  const int64_t n_chunks = (S + kChunk - 1) / kChunk;
  const int64_t blocks = (int64_t)n_cl * kCluster * n_chunks * B;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  e = cudaMemsetAsync(flags, 0,
                      sizeof(int) * (1 + 2 * (size_t)B * n_cl * kCluster),
                      stream);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(BwdSmem<Tu>);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssm_scan_bwd_kernel<Tu, kVec>, u, dt, Bc, Cc,
                         A, chunk_h, dy, du, ddt, part_b, part_c, part_a,
                         carry, flags, B, S, di, ds, n_cl);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename Tu>
cudaError_t launch_bwd(const void* u, const float* dt, const float* Bc,
                       const float* Cc, const float* A, const float* chunk_h,
                       const float* dy, void* du, float* ddt, float* dB,
                       float* dC, float* dA, float* part_b, float* part_c,
                       float* part_a, float* carry, int* flags, int B, int S,
                       int di, int ds, cudaStream_t stream) {
  const Tu* up = static_cast<const Tu*>(u);
  Tu* dup = static_cast<Tu*>(du);
  const bool vec = ds == kStates && di % kChannels == 0 && aligned16(u) &&
                   aligned16(dt) && aligned16(dy) && aligned16(Bc) &&
                   aligned16(Cc);
  cudaError_t e =
      vec ? launch_bwd_vec<Tu, true>(up, dt, Bc, Cc, A, chunk_h, dy, dup,
                                     ddt, part_b, part_c, part_a, carry,
                                     flags, B, S, di, ds, stream)
          : launch_bwd_vec<Tu, false>(up, dt, Bc, Cc, A, chunk_h, dy, dup,
                                      ddt, part_b, part_c, part_a, carry,
                                      flags, B, S, di, ds, stream);
  if (e != cudaSuccess) return e;
  const int n_cl = bwd_clusters(di);
  const int64_t n_bc = (int64_t)B * S * ds;
  if ((e = sum_partials(part_b, dB, n_cl, n_bc, stream)) != cudaSuccess)
    return e;
  if ((e = sum_partials(part_c, dC, n_cl, n_bc, stream)) != cudaSuccess)
    return e;
  return sum_partials(part_a, dA, B, (int64_t)di * ds, stream);
}

template <typename Tu>
cudaError_t bwd_attrs(int* out) {
  constexpr size_t smem = sizeof(BwdSmem<Tu>);
  auto* kernel = ssm_scan_bwd_kernel<Tu, true>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) e = set_bwd_smem<Tu, true>();
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
// (di, ds), all fp32 but du.  Scratch: part_b and part_c (ceil(di / 256),
// B, S, ds) and part_a (B, di, ds) fp32 for the clusters' and batch rows'
// partial sums, carry (B, di, ds) fp32 for the carry between chunks, and
// flags (1 + 2 * B * 8 * ceil(di / 256)) int32, which the call zeroes.
// All contiguous.  A memset and four launches on the stream, in order.
extern "C" int ssm_scan_bwd(const void* u, const void* dt, const void* Bc,
                            const void* Cc, const void* A,
                            const void* chunk_h, const void* dy, void* du,
                            void* ddt, void* dB, void* dC, void* dA,
                            void* part_b, void* part_c, void* part_a,
                            void* carry, void* flags, int B, int S, int di,
                            int ds, int u_dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || ds <= 0 || ds > kStates)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  int* fl = static_cast<int*>(flags);
  switch (u_dtype) {
    case REPRO_F32:
      return launch_bwd<float>(u, f(dt), f(Bc), f(Cc), f(A), f(chunk_h),
                               f(dy), du, w(ddt), w(dB), w(dC), w(dA),
                               w(part_b), w(part_c), w(part_a), w(carry), fl,
                               B, S, di, ds, s);
    case REPRO_BF16:
      return launch_bwd<__nv_bfloat16>(u, f(dt), f(Bc), f(Cc), f(A),
                                       f(chunk_h), f(dy), du, w(ddt), w(dB),
                                       w(dC), w(dA), w(part_b), w(part_c),
                                       w(part_a), w(carry), fl, B, S, di, ds,
                                       s);
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
