// Flash attention forward for Hopper.  Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention (_kernel).
//
// Tiled online-softmax attention: causal mask, sliding window, logit
// softcap, GQA (kv head = h / (H/Hk), K/V never repeated), positions
// aligned at the END when Sq != Sk, q/k/v read as (B,S,H,hd) through their
// strides (no transposes).  A query row with no visible key writes 0.
//
// On the TPU the kv blocks were a sequential grid dimension carrying m/l/acc
// in VMEM scratch.  Here one thread block owns a (b, h, 64-row q tile) and a
// loop inside the block walks the kv tiles; the fp32 running max m, sum l
// and the 64 x hd accumulator stay in registers for the whole loop, so the
// S = QK^T scores never reach device memory.  Only kv tiles inside the
// causal/window band are visited (the TPU kernel's block skip), and ragged
// Sq/Sk are masked instead of asserted divisible.
//
// Bound: at the serving shapes (S = 1000, hd = 128) the work is ~4*S^2/2*hd
// operations per head against ~4*S*hd*2 bytes, far above the card's
// operations-per-byte balance, so the bound is the bf16 tensor-core rate.
// This first version computes both products with fp32 FMAs on the CUDA
// cores from fp32 tiles in shared memory (so fp32 and bf16 inputs share one
// path): it is right, and it is several times off that bound.  The
// tensor-core (mma/wgmma) version is later work.
#include <math.h>

#include "common.cuh"

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
  int B, Sq, Sk, H, Hk;
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

template <typename T, int HD>
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the kv range [k_lo, k_hi) any row of this tile can see
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(p.Sk, q_last + off + 1);
  if (p.window > 0) k_lo = max(0, q0 + off - p.window + 1);

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[d * (kBQ + 1) + r] = qi < p.Sq ? to_f32(qg[qi * p.q_ss + d]) : 0.f;
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
      const bool in = kj < p.Sk;
      Ks[d * (kBK + 1) + r] = in ? to_f32(kg[kj * p.k_ss + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vg[kj * p.v_ss + d]) : 0.f;
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

  // out is contiguous (B, Sq, H, HD)
  T* og = static_cast<T*>(p.o) + ((long long)b * p.Sq * p.H + h) * HD;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = og + (long long)qi * p.H * HD;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      orow[tx + 8 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const FlashParams& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,Sq,H,hd), k/v: (B,Sk,Hk,hd) with unit stride on hd and the given
// element strides for b, s, h; o: contiguous (B,Sq,H,hd) of q's dtype.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int Hk, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float softcap, float sm_scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const FlashParams p{q,    k,    v,    o,    B,    Sq,     Sk,      H,
                      Hk,   q_sb, q_ss, q_sh, k_sb, k_ss,   k_sh,    v_sb,
                      v_ss, v_sh, causal, window, softcap, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return dispatch_hd<float>(p, hd, s);
    case REPRO_BF16: return dispatch_hd<__nv_bfloat16>(p, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
