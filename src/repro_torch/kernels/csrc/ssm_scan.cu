// Mamba-1 selective scan (diagonal A) for Hopper.  Replaces the Pallas
// kernel repro/kernels/ssm_scan.py::ssm_scan (_kernel).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t      (di, ds) state
//   y_t = sum_n h_t[:, n] * C_t[n]
//
// fp32 throughout; u is read as bf16 or fp32 and upcast on load.  Returns y
// (B, S, di) and the last state h_S (B, di, ds), which the prefill keeps as
// the decode state.  No D skip and no gate: the caller adds them.
//
// What bounds it: each input byte is read once and each output written
// once (~83 MB at B1 S1000 di8192 ds16 with bf16 u: 0.025 ms at the H100
// SXM's data-sheet 3.35 TB/s, 700 W), but the B*S*di*ds exponentials (131 M
// there) are a higher floor on the special-function units (16 per SM per
// clock, 132 SMs at the 1.98 GHz boost clock: ~0.031 ms).
//
// Design.  On the TPU one grid cell keeps a (di_block, ds) state in VMEM
// and walks the chunks of S in order.  Here the parallelism must come from
// B*di*ds: one thread owns one (b, d, n) state element in a register for
// the whole sequence, 16 lanes per channel (ds <= 16; lanes past ds carry
// zeros), 16 channels per 256-thread block.  The block walks S in chunks of
// kChunk steps: dt, dt*u, B and C of the chunk are staged in shared memory
// with coalesced loads, each step's y[t, d] is a 16-lane shuffle sum staged
// in shared memory, and the chunk's y is written out coalesced.  Any S (a
// partial last chunk is masked) and any di (a partial last block of
// channels is masked).  expf, not __expf: the state is a product of up to S
// decays, and the fast version's error grows with |dt * A|.
#include "common.cuh"

namespace {

constexpr int kLanes = 16;                    // state lanes per channel
constexpr int kChannels = 16;                 // channels per block
constexpr int kThreads = kLanes * kChannels;  // 256
constexpr int kChunk = 64;                    // time steps staged per pass

template <typename Tu>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const Tu* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_last, int S, int di, int ds) {
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_du[kChunk][kChannels];   // dt * u
  __shared__ float s_b[kChunk][kLanes];
  __shared__ float s_c[kChunk][kLanes];
  __shared__ float s_y[kChunk][kChannels];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kLanes;                 // channel in the block
  const int n = tid % kLanes;                 // state index
  const int d = d0 + c;
  const bool live = d < di && n < ds;
  const float a = live ? A[(int64_t)d * ds + n] : 0.f;
  const int64_t row0 = (int64_t)b * S;        // first (b, t) row
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int T = min(kChunk, S - t0);
    for (int i = tid; i < T * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      float dtv = 0.f, uv = 0.f;
      if (d0 + cc < di) {
        const int64_t off = (row0 + t0 + tt) * di + d0 + cc;
        dtv = dt[off];
        uv = to_f32(u[off]);
      }
      s_dt[tt][cc] = dtv;
      s_du[tt][cc] = dtv * uv;
    }
    for (int i = tid; i < T * kLanes; i += kThreads) {
      const int tt = i / kLanes, nn = i % kLanes;
      float bv = 0.f, cv = 0.f;
      if (nn < ds) {
        const int64_t off = (row0 + t0 + tt) * ds + nn;
        bv = Bc[off];
        cv = Cc[off];
      }
      s_b[tt][nn] = bv;
      s_c[tt][nn] = cv;
    }
    __syncthreads();
    // every thread runs every step: the shuffles need all 32 lanes
#pragma unroll 4
    for (int tt = 0; tt < T; ++tt) {
      const float decay = expf(s_dt[tt][c] * a);
      h = fmaf(decay, h, s_du[tt][c] * s_b[tt][n]);
      float p = h * s_c[tt][n];
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) s_y[tt][c] = p;
    }
    __syncthreads();
    for (int i = tid; i < T * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      if (d0 + cc < di) y[(row0 + t0 + tt) * di + d0 + cc] = s_y[tt][cc];
    }
    // the next chunk's staging writes no buffer read above, and its time
    // loop writes s_y only after the next __syncthreads
  }
  if (live) h_last[((int64_t)b * di + d) * ds + n] = h;
}

template <typename Tu>
cudaError_t launch(const void* u, const float* dt, const float* Bc,
                   const float* Cc, const float* A, float* y, float* h_last,
                   int B, int S, int di, int ds, cudaStream_t stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<Tu><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tu*>(u), dt, Bc, Cc, A, y, h_last, S, di, ds);
  return cudaGetLastError();
}

}  // namespace

// u: (B, S, di) of u_dtype; dt: (B, S, di); Bc, Cc: (B, S, ds); A: (di, ds)
// -> y: (B, S, di), h_last: (B, di, ds).  All contiguous; all but u fp32.
extern "C" int ssm_scan_fwd(const void* u, const void* dt, const void* Bc,
                            const void* Cc, const void* A, void* y,
                            void* h_last, int B, int S, int di, int ds,
                            int u_dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || ds <= 0 || ds > kLanes)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* bp = static_cast<const float*>(Bc);
  const float* cp = static_cast<const float*>(Cc);
  const float* ap = static_cast<const float*>(A);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(h_last);
  switch (u_dtype) {
    case REPRO_F32:
      return launch<float>(u, dtp, bp, cp, ap, yp, hp, B, S, di, ds, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(u, dtp, bp, cp, ap, yp, hp, B, S, di, ds,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}
