// SwiGLU gate for Hopper.  Replaces the Pallas kernel
// repro/kernels/swiglu.py::swiglu (_kernel).
//
// out = silu(g) * u computed in fp32, written directly in the output dtype
// (this fuses the model's cast of the MLP hidden state back to x.dtype).
// Bound by bytes: each element of g and u is read once and each output
// written once, by a grid-stride loop of 16-byte vector loads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

template <typename Ti, typename To, int VEC>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const Ti* __restrict__ g, const Ti* __restrict__ u,
              To* __restrict__ out, int64_t n_vec) {
  using PI = Pack<Ti, VEC>;
  using PO = Pack<To, VEC>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const PI gp = reinterpret_cast<const PI*>(g)[i];
    const PI up = reinterpret_cast<const PI*>(u)[i];
    PO o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gf = to_f32(gp.v[j]);
      const float sig = 1.f / (1.f + expf(-gf));
      o.v[j] = from_f32<To>(gf * sig * to_f32(up.v[j]));
    }
    reinterpret_cast<PO*>(out)[i] = o;
  }
}

template <typename Ti, typename To, int VEC>
cudaError_t launch(const void* g, const void* u, void* out, int64_t n,
                   cudaStream_t stream) {
  const int64_t n_vec = n / VEC;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  swiglu_kernel<Ti, To, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const Ti*>(g), static_cast<const Ti*>(u),
      static_cast<To*>(out), n_vec);
  return cudaGetLastError();
}

template <typename Ti, typename To>
cudaError_t dispatch(const void* g, const void* u, void* out, int64_t n,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Ti);
  if (n % kVec == 0 && aligned16(g) && aligned16(u) &&
      (reinterpret_cast<uintptr_t>(out) % (kVec * sizeof(To))) == 0)
    return launch<Ti, To, kVec>(g, u, out, n, stream);
  return launch<Ti, To, 1>(g, u, out, n, stream);
}

}  // namespace

// g, u: n contiguous elements of in_dtype; out: n elements of out_dtype.
extern "C" int swiglu_fwd(const void* g, const void* u, void* out,
                          long long n, int in_dtype, int out_dtype,
                          void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == REPRO_F32 && out_dtype == REPRO_F32)
    return dispatch<float, float>(g, u, out, n, s);
  if (in_dtype == REPRO_F32 && out_dtype == REPRO_BF16)
    return dispatch<float, __nv_bfloat16>(g, u, out, n, s);
  if (in_dtype == REPRO_BF16 && out_dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(g, u, out, n, s);
  if (in_dtype == REPRO_BF16 && out_dtype == REPRO_F32)
    return dispatch<__nv_bfloat16, float>(g, u, out, n, s);
  return cudaErrorInvalidValue;
}
