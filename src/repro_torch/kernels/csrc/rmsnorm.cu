// RMSNorm forward for Hopper.  Replaces the Pallas kernel
// repro/kernels/rmsnorm.py::rmsnorm (_kernel).
//
// out = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32, written in
// x's dtype.  Bound by bytes (2*R*D*sizeof(x) + D*sizeof(scale)): one block
// per row (one warp per row when D <= 1024), 16-byte vector loads and
// stores, the sum of squares reduced by warp shuffles and one shared-memory
// pass.  Any row count: no padding to a block of rows as on the TPU.
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
