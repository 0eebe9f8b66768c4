// RMSNorm forward for Hopper.  Replaces the Pallas kernel
// repro/kernels/rmsnorm.py::rmsnorm (_kernel).
//
// out = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32, written in
// x's dtype.  Bound by bytes (2*R*D*sizeof(x) + D*sizeof(scale)): one block
// per row (one warp per row when D <= 1024), 16-byte vector loads and
// stores, the sum of squares reduced by warp shuffles and one shared-memory
// pass.  Any row count: no padding to a block of rows as on the TPU.
//
// rmsnorm_bwd is its VJP (the JAX package differentiates the jnp oracle;
// the training path needs a kernel).  With r = rsqrt(mean(x^2) + eps) and
// g = dy * scale: dx = r*g - x * r^3 * mean(g*x), written in x's dtype,
// and dscale = sum over rows of dy*x*r in fp32.  Bound by bytes (x, dy
// read once, dx written once).  Each block walks rows with a stride of
// the grid and recomputes r from its row; each thread owns the same
// columns in every row, so it sums its dscale columns in shared memory
// without atomics, and a second small pass adds the blocks' partial rows.
#include "common.cuh"

namespace {

constexpr int kBlockThreads = 256;
constexpr int kWarpRowsPerBlock = 4;

template <typename T, int VEC>
__device__ __forceinline__ float sum_squares(const T* __restrict__ xr, int D,
                                             int start, int step) {
  using P = Pack<T, VEC>;
  float ss = 0.f;
  for (int i = start * VEC; i < D; i += step * VEC) {
    const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(p.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
  return ss;
}

template <typename T, int VEC>
__device__ __forceinline__ void scale_row(const T* __restrict__ xr,
                                          const T* __restrict__ scale,
                                          T* __restrict__ orow, int D,
                                          float r, int start, int step) {
  using P = Pack<T, VEC>;
  for (int i = start * VEC; i < D; i += step * VEC) {
    const P p = *reinterpret_cast<const P*>(xr + i);
    const P s = *reinterpret_cast<const P*>(scale + i);
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f32<T>(to_f32(p.v[j]) * r * to_f32(s.v[j]));
    *reinterpret_cast<P*>(orow + i) = o;
  }
}

// one block of kBlockThreads per row
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     T* __restrict__ out, int D, float eps) {
  __shared__ float partial[kBlockThreads / 32];
  __shared__ float total;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  float ss = warp_sum(sum_squares<T, VEC>(xr, D, threadIdx.x, blockDim.x));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float r = rsqrtf(total / D + eps);
  scale_row<T, VEC>(xr, scale, out + row * D, D, r, threadIdx.x, blockDim.x);
}

// one warp per row, kWarpRowsPerBlock rows per block (D <= 1024)
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, int64_t rows, int D, float eps) {
  const int64_t row =
      (int64_t)blockIdx.x * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * D;
  const float ss = warp_sum(sum_squares<T, VEC>(xr, D, lane, 32));
  const float r = rsqrtf(ss / D + eps);
  scale_row<T, VEC>(xr, scale, out + row * D, D, r, lane, 32);
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* scale, void* out, int64_t rows,
                   int D, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
  if (D <= 1024) {
    const int64_t blocks = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
    rmsnorm_warp_kernel<T, VEC><<<(unsigned)blocks, 32 * kWarpRowsPerBlock, 0,
                                  stream>>>(xp, sp, op, rows, D, eps);
  } else {
    rmsnorm_block_kernel<T, VEC><<<(unsigned)rows, kBlockThreads, 0,
                                   stream>>>(xp, sp, op, D, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, void* out,
                     int64_t rows, int D, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (D % kVec == 0 && aligned16(x) && aligned16(scale) && aligned16(out))
    return launch<T, kVec>(x, scale, out, rows, D, eps, stream);
  return launch<T, 1>(x, scale, out, rows, D, eps, stream);
}

// ------------------------------------------------------------ backward ---
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int64_t rows, int D,
                   float eps) {
  using P = Pack<T, VEC>;
  extern __shared__ float dscale[];           // [D], one owner per column
  __shared__ float red[2][kBlockThreads / 32];
  __shared__ float total[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int step = blockDim.x * VEC;
  for (int i = threadIdx.x * VEC; i < D; i += step)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dscale[i + j] = 0.f;

  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float ss = 0.f, sg = 0.f;
    for (int i = threadIdx.x * VEC; i < D; i += step) {
      const P xp = *reinterpret_cast<const P*>(xr + i);
      const P gp = *reinterpret_cast<const P*>(gr + i);
      const P sp = *reinterpret_cast<const P*>(scale + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f32(xp.v[j]);
        ss = fmaf(xf, xf, ss);
        sg = fmaf(to_f32(gp.v[j]) * to_f32(sp.v[j]), xf, sg);
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sg;
    }
    __syncthreads();
    if (warp == 0) {
      const bool in = lane < (int)(blockDim.x >> 5);
      const float a = warp_sum(in ? red[0][lane] : 0.f);
      const float c = warp_sum(in ? red[1][lane] : 0.f);
      if (lane == 0) {
        total[0] = a;
        total[1] = c;
      }
    }
    __syncthreads();
    const float r = rsqrtf(total[0] / D + eps);
    const float c = r * r * r * total[1] / D;
    for (int i = threadIdx.x * VEC; i < D; i += step) {
      const P xp = *reinterpret_cast<const P*>(xr + i);
      const P gp = *reinterpret_cast<const P*>(gr + i);
      const P sp = *reinterpret_cast<const P*>(scale + i);
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f32(xp.v[j]), gf = to_f32(gp.v[j]);
        o.v[j] = from_f32<T>(r * gf * to_f32(sp.v[j]) - xf * c);
        dscale[i + j] = fmaf(gf * xf, r, dscale[i + j]);
      }
      *reinterpret_cast<P*>(dx + row * D + i) = o;
    }
  }
  for (int i = threadIdx.x * VEC; i < D; i += step)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      partial[(int64_t)blockIdx.x * D + i + j] = dscale[i + j];
}

// out[j] = sum over the nb partial rows of column j
__global__ void __launch_bounds__(kBlockThreads)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int nb, int D) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) acc += partial[(int64_t)b * D + j];
  out[j] = acc;
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy,
                       void* dx, float* partial, float* dscale,
                       int64_t rows, int D, int nb, float eps,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * D;
  cudaError_t e = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_kernel<T, VEC><<<nb, kBlockThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, D, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  column_sum_kernel<<<(D + kBlockThreads - 1) / kBlockThreads, kBlockThreads,
                      0, stream>>>(partial, dscale, nb, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* scale, const void* dy,
                         void* dx, float* partial, float* dscale,
                         int64_t rows, int D, int nb, float eps,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (D % kVec == 0 && aligned16(x) && aligned16(scale) && aligned16(dy) &&
      aligned16(dx))
    return launch_bwd<T, kVec>(x, scale, dy, dx, partial, dscale, rows, D,
                               nb, eps, stream);
  return launch_bwd<T, 1>(x, scale, dy, dx, partial, dscale, rows, D, nb,
                          eps, stream);
}

}  // namespace

// x, out: (rows, D) contiguous; scale: (D,) of x's dtype.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           long long rows, int D, float eps, int dtype,
                           void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return dispatch<float>(x, scale, out, rows, D, eps, s);
    case REPRO_BF16:
      return dispatch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, dy, dx: (rows, D) contiguous of one dtype; scale: (D,) of that dtype;
// partial: fp32 scratch (nb, D); dscale: fp32 (D,).  nb blocks, each
// walking rows with a stride of nb.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* partial, void* dscale,
                           long long rows, int D, int nb, float eps,
                           int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || nb <= 0 || nb > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  switch (dtype) {
    case REPRO_F32:
      return dispatch_bwd<float>(x, scale, dy, dx, part, ds, rows, D, nb,
                                 eps, s);
    case REPRO_BF16:
      return dispatch_bwd<__nv_bfloat16>(x, scale, dy, dx, part, ds, rows, D,
                                         nb, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
