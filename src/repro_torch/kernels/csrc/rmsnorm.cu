// RMSNorm forward and backward for Hopper.  Replaces the Pallas kernel
// repro/kernels/rmsnorm.py::rmsnorm (_kernel); the backward is its VJP
// (the JAX package differentiates the jnp oracle; training needs a kernel).
//
// Forward: out = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32,
// written in x's dtype.  Bound by bytes (2*R*D*sizeof(x) + D*sizeof(scale)).
// A row is split over a block (or, when it fits, over one warp, several
// rows a block): thread t holds packs t, t + threads, ... of 16 bytes (or
// of one element when D or a pointer does not allow 16) in registers,
// loads x and scale together before the reduction, and meets the others at
// one barrier.  Each row is read once.  A D beyond the register template
// (packs_for below) runs the loop kernel, which reads a row twice.
//
// Backward: with r = rsqrt(mean(x^2) + eps) and g = dy * scale,
// dx = r*g - x * r^3 * mean(g*x) in x's dtype and dscale = sum over rows
// of dy*x*r in fp32.  Bound by bytes (x, dy read once, dx written once).
// One cooperative launch of at most kBwdBlocksPerSM blocks an SM, each
// walking rows with a stride of the grid, the grid cut so that every block
// takes the same number of rows or one less:
//   * every thread owns the same columns in every row, so its dscale
//     terms stay in fp32 registers (no shared memory, no atomics);
//   * scale is loaded once a block, into registers;
//   * rows arrive through a ring of kStages rows of x and dy in shared
//     memory, filled with cp.async: a thread copies only the columns it
//     reads, so the ring needs no barrier, and the next two rows are in
//     flight while the current one reduces.  Each row is read once;
//   * after the rows, each block writes its partial dscale row, all blocks
//     meet at a grid barrier (the cooperative launch guarantees they are
//     all resident), and each block adds a slice of columns over the nb
//     partial rows in a fixed order: deterministic, bit-identical from
//     call to call at a shape.  A last-block-sums design would read every
//     partial row on one SM.
// A D that is not a multiple of 16 bytes, an unaligned pointer or a row
// beyond the ring runs the general kernel: the same launch and reduction,
// element by element, its partial dscale row accumulated in place.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // most threads of a block on a row
constexpr int kWarpRows = 4;         // rows a block when a row fits a warp
constexpr int kStages = 3;           // rows of x and dy in the bwd ring
constexpr int kBwdBlocksPerSM = 1;   // cap on resident bwd blocks an SM

// Packs a thread holds so that at most kThreads threads cover D / vec
// packs: 1, 2, 4 or 8; 0 beyond the register template (D > 8 * vec *
// kThreads: 16384 in bf16, 8192 in fp32 with 16-byte packs).  At (8, 4096)
// bf16, 256 threads of 2 packs beat 64, 128 and 512 threads (PERF.md).
int packs_for(int D, int vec) {
  const int n = D / vec;
  for (int p = 1; p <= 8; p *= 2)
    if ((n + p - 1) / p <= kThreads) return p;
  return 0;
}

// threads a block for `packs` packs a thread, a multiple of the warp
int threads_for(int D, int vec, int packs) {
  const int t = (D / vec + packs - 1) / packs;
  return (t + 31) / 32 * 32;
}

// --------------------------------------------------------------- forward ---
// x * r * scale for the packs a thread holds; `lane`/`nthr` place them.
template <typename T, int VEC, int PACKS>
__device__ __forceinline__ void fwd_row(const T* __restrict__ xr,
                                        const T* __restrict__ scale,
                                        T* __restrict__ orow, int D,
                                        float eps, int lane, int nthr,
                                        float* red) {
  using P = Pack<T, VEC>;
  P xp[PACKS], sp[PACKS];
#pragma unroll
  for (int p = 0; p < PACKS; ++p) {
    const int c = (p * nthr + lane) * VEC;
    if (c < D) {
      xp[p] = *reinterpret_cast<const P*>(xr + c);
      sp[p] = *reinterpret_cast<const P*>(scale + c);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < PACKS; ++p) {
    if ((p * nthr + lane) * VEC < D) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(xp[p].v[j]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  ss = warp_sum(ss);
  if (red != nullptr) {  // a block on the row: one barrier
    if ((lane & 31) == 0) red[lane >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < (nthr >> 5); ++w) ss += red[w];
  }
  const float r = rsqrtf(ss / D + eps);
#pragma unroll
  for (int p = 0; p < PACKS; ++p) {
    const int c = (p * nthr + lane) * VEC;
    if (c < D) {
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f32<T>(to_f32(xp[p].v[j]) * r * to_f32(sp[p].v[j]));
      *reinterpret_cast<P*>(orow + c) = o;
    }
  }
}

// one block of blockDim.x threads per row, the row in registers
template <typename T, int VEC, int PACKS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int64_t rows, int D, float eps) {
  __shared__ float red[kThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * D;
  fwd_row<T, VEC, PACKS>(x + base, scale, out + base, D, eps, threadIdx.x,
                         blockDim.x, red);
}

// one warp per row, kWarpRows rows a block, the row in registers
template <typename T, int VEC, int PACKS>
__global__ void __launch_bounds__(32 * kWarpRows)
rmsnorm_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        T* __restrict__ out, int64_t rows, int D,
                        float eps) {
  const int64_t row = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  fwd_row<T, VEC, PACKS>(x + row * D, scale, out + row * D, D, eps,
                         threadIdx.x & 31, 32, nullptr);
}

// a row beyond the register template: one block a row, read twice
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, int64_t rows, int D, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[kThreads / 32];
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* orow = out + (int64_t)blockIdx.x * D;
  const int step = blockDim.x * VEC;
  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < D; i += step) {
    const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(p.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) ss += red[w];
  const float r = rsqrtf(ss / D + eps);
  for (int i = threadIdx.x * VEC; i < D; i += step) {
    const P p = *reinterpret_cast<const P*>(xr + i);
    const P s = *reinterpret_cast<const P*>(scale + i);
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f32<T>(to_f32(p.v[j]) * r * to_f32(s.v[j]));
    *reinterpret_cast<P*>(orow + i) = o;
  }
}

// A kernel as launched: its block, the rows a block takes (forward) and its
// dynamic shared memory.
struct Plan {
  const void* kernel;
  int threads;
  int rows_a_block;
  size_t smem;
};

template <typename T, int VEC, int PACKS>
Plan fwd_plan_packs(int threads) {
  if (threads == 32)
    return {(const void*)rmsnorm_fwd_warp_kernel<T, VEC, PACKS>,
            32 * kWarpRows, kWarpRows, 0};
  return {(const void*)rmsnorm_fwd_kernel<T, VEC, PACKS>, threads, 1, 0};
}

// the forward kernel that serves D with packs of VEC
template <typename T, int VEC>
Plan fwd_plan(int D) {
  const int packs = packs_for(D, VEC);
  const int threads = packs ? threads_for(D, VEC, packs) : 0;
  switch (packs) {
    case 1: return fwd_plan_packs<T, VEC, 1>(threads);
    case 2: return fwd_plan_packs<T, VEC, 2>(threads);
    case 4: return fwd_plan_packs<T, VEC, 4>(threads);
    case 8: return fwd_plan_packs<T, VEC, 8>(threads);
    default:
      return {(const void*)rmsnorm_loop_kernel<T, VEC>, kThreads, 1, 0};
  }
}

template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* scale, void* out,
                         int64_t rows, int D, float eps,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const Plan p =
      D % kVec == 0 && aligned16(x) && aligned16(scale) && aligned16(out)
          ? fwd_plan<T, kVec>(D)
          : fwd_plan<T, 1>(D);
  const int64_t blocks = (rows + p.rows_a_block - 1) / p.rows_a_block;
  void* args[] = {&x, &scale, &out, &rows, &D, &eps};
  cudaError_t e = cudaLaunchKernel(p.kernel, dim3((unsigned)blocks),
                                   dim3(p.threads), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// -------------------------------------------------------------- backward ---
// cp.async of 16 bytes, its groups, and the wait for all but the newest N.
// The "memory" clobbers keep the compiler from moving this thread's shared
// loads across them (no block barrier stands between a wait and the reads).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's sums of two values, by every thread.  `red` is double
// buffered by row parity: a thread writes row i+2's slot only after the
// barrier of row i+1, which every thread reaches after reading row i's.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float (*red)[2]) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = a;
    red[threadIdx.x >> 5][1] = b;
  }
  __syncthreads();
  a = b = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    a += red[w][0];
    b += red[w][1];
  }
  return make_float2(a, b);
}

// Grid-wide barrier of a cooperative launch.  The counter's low 31 bits
// are 0 between calls: block 0 adds 2^31 - (nb - 1) and every other block
// 1, so the top bit flips when the last block arrives, and the low bits
// are 0 again for the next call whatever its grid.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();  // this block's partial row before its arrival
    const unsigned int old = atomicAdd(bar, add);
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(now)
                   : "l"(bar)
                   : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// dscale[j] = sum of partial[b][j] over the nb = gridDim.x blocks' rows.
// Each block takes a slice of the columns, C at a time (C = 4: float4
// loads); `groups` threads a chunk of C add rows b = g, g + groups, ... in
// order, in fp64, and the groups' sums are added in order, so the order is
// fixed for a given grid and block and the one fp32 rounding is the last.
template <int C>
__device__ __forceinline__ void column_sums(const float* __restrict__ partial,
                                            float* __restrict__ dscale, int D,
                                            double* sh) {
  const int nb = gridDim.x, nthr = blockDim.x, t = threadIdx.x;
  const int chunks = D / C;
  const int per = (chunks + nb - 1) / nb;
  const int q0 = blockIdx.x * per, q1 = min(chunks, q0 + per);
  const int w = min(per, nthr), groups = nthr / w;
  const int g = t / w;
  for (int qb = q0; qb < q1; qb += w) {
    const int q = qb + t % w;
    double acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.0;
    if (g < groups && q < q1) {
#pragma unroll 4
      for (int b = g; b < nb; b += groups) {
        const float* src = partial + (int64_t)b * D + q * C;
        if constexpr (C == 4) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
          acc[0] += v.x;
          acc[1] += v.y;
          acc[2] += v.z;
          acc[3] += v.w;
        } else {
          acc[0] += __ldcg(src);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) sh[j * nthr + t] = acc[j];
    __syncthreads();
    for (int u = t; u < w * C; u += nthr) {  // one (chunk, element) each
      const int col = u % w, j = u / w;
      if (qb + col < q1) {
        double s = 0.0;
        for (int k = 0; k < groups; ++k) s += sh[j * nthr + k * w + col];
        dscale[(qb + col) * C + j] = (float)s;
      }
    }
    __syncthreads();
  }
}

// 16-byte packs of rows through a cp.async ring; PACKS a thread
template <typename T, int PACKS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_ring_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial,
                        float* __restrict__ dscale, unsigned int* bar,
                        int64_t rows, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][x, dy][D]
  __shared__ float red[2][kThreads / 32][2];
  __shared__ double sh[4 * kThreads];
  const int t = threadIdx.x, nthr = blockDim.x;
  const int64_t stride = gridDim.x;

  // dscale terms in fp32 (in fp64, with its conversions, the kernel took
  // 1.3 us more at (4096, 4096) bf16: PERF.md)
  P sp[PACKS];
  float ds[PACKS][VEC];
#pragma unroll
  for (int p = 0; p < PACKS; ++p) {
    const int c = (p * nthr + t) * VEC;
    if (c < D) sp[p] = *reinterpret_cast<const P*>(scale + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ds[p][j] = 0.f;
  }
  // row -> ring stage, this thread's columns only; an empty group past
  // the last row keeps the group count uniform
  auto fetch = [&](int64_t row, int stage) {
    if (row < rows) {
      T* sx = ring + (size_t)stage * 2 * D;
#pragma unroll
      for (int p = 0; p < PACKS; ++p) {
        const int c = (p * nthr + t) * VEC;
        if (c < D) {
          copy16_async(sx + c, x + row * D + c);
          copy16_async(sx + D + c, dy + row * D + c);
        }
      }
    }
    copy_commit();
  };

  int64_t row = blockIdx.x;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(row + k * stride, k);
  for (int i = 0; row < rows; ++i, row += stride) {
    fetch(row + (kStages - 1) * stride, (i + kStages - 1) % kStages);
    copy_wait<kStages - 1>();  // this row's group has landed
    const T* sx = ring + (size_t)(i % kStages) * 2 * D;
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int p = 0; p < PACKS; ++p) {
      const int c = (p * nthr + t) * VEC;
      if (c < D) {
        const P xv = *reinterpret_cast<const P*>(sx + c);
        const P gv = *reinterpret_cast<const P*>(sx + D + c);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f32(xv.v[j]);
          ss = fmaf(xf, xf, ss);
          sgx = fmaf(to_f32(gv.v[j]) * to_f32(sp[p].v[j]), xf, sgx);
        }
      }
    }
    const float2 tot = block_sum2(ss, sgx, red[i & 1]);
    const float r = rsqrtf(tot.x / D + eps);
    const float k = r * r * r * tot.y / D;
#pragma unroll
    for (int p = 0; p < PACKS; ++p) {
      const int c = (p * nthr + t) * VEC;
      if (c < D) {
        const P xv = *reinterpret_cast<const P*>(sx + c);
        const P gv = *reinterpret_cast<const P*>(sx + D + c);
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f32(xv.v[j]), gf = to_f32(gv.v[j]);
          o.v[j] = from_f32<T>(r * gf * to_f32(sp[p].v[j]) - xf * k);
          ds[p][j] = fmaf(gf * xf, r, ds[p][j]);
        }
        *reinterpret_cast<P*>(dx + row * D + c) = o;
      }
    }
  }
  copy_wait<0>();
  float* mine = partial + (int64_t)blockIdx.x * D;
#pragma unroll
  for (int p = 0; p < PACKS; ++p) {
    const int c = (p * nthr + t) * VEC;
    if (c < D) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(mine + c + j) =
            make_float4(ds[p][j], ds[p][j + 1], ds[p][j + 2], ds[p][j + 3]);
    }
  }
  grid_barrier(bar);
  column_sums<4>(partial, dscale, D, sh);
}

// any D and alignment, element by element; the block's partial dscale row
// is accumulated in place (each thread its own columns)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_general_kernel(const T* __restrict__ x,
                           const T* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial,
                           float* __restrict__ dscale, unsigned int* bar,
                           int64_t rows, int D, float eps) {
  __shared__ float red[2][kThreads / 32][2];
  __shared__ double sh[kThreads];
  const int t = threadIdx.x, nthr = blockDim.x;
  float* mine = partial + (int64_t)blockIdx.x * D;
  for (int c = t; c < D; c += nthr) mine[c] = 0.f;
  int i = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x, ++i) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float ss = 0.f, sgx = 0.f;
    for (int c = t; c < D; c += nthr) {
      const float xf = to_f32(xr[c]);
      ss = fmaf(xf, xf, ss);
      sgx = fmaf(to_f32(gr[c]) * to_f32(scale[c]), xf, sgx);
    }
    const float2 tot = block_sum2(ss, sgx, red[i & 1]);
    const float r = rsqrtf(tot.x / D + eps);
    const float k = r * r * r * tot.y / D;
    for (int c = t; c < D; c += nthr) {
      const float xf = to_f32(xr[c]), gf = to_f32(gr[c]);
      dx[row * D + c] = from_f32<T>(r * gf * to_f32(scale[c]) - xf * k);
      mine[c] = fmaf(gf * xf, r, mine[c]);
    }
  }
  grid_barrier(bar);
  column_sums<1>(partial, dscale, D, sh);
}

struct BwdArgs {
  const void* x;
  const void* scale;
  const void* dy;
  void* dx;
  float* partial;
  float* dscale;
  unsigned int* bar;
  int64_t rows;
  int D;
  float eps;
};

// The backward kernel that serves D: the ring when 16-byte packs fit, else
// the general kernel.
template <typename T>
Plan bwd_plan(int D, bool aligned) {
  constexpr int kVec = 16 / sizeof(T);
  const int packs = packs_for(D, kVec);
  const size_t smem = (size_t)kStages * 2 * D * sizeof(T);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // static shared memory of the ring kernel: red and sh
  const size_t fixed =
      sizeof(float) * (kThreads / 32 * 4) + sizeof(double) * 4 * kThreads;
  if (aligned && D % kVec == 0 && packs && smem + fixed <= (size_t)optin) {
    const int threads = threads_for(D, kVec, packs);
    switch (packs) {
      case 1: return {(const void*)rmsnorm_bwd_ring_kernel<T, 1>, threads,
                      1, smem};
      case 2: return {(const void*)rmsnorm_bwd_ring_kernel<T, 2>, threads,
                      1, smem};
      case 4: return {(const void*)rmsnorm_bwd_ring_kernel<T, 4>, threads,
                      1, smem};
      case 8: return {(const void*)rmsnorm_bwd_ring_kernel<T, 8>, threads,
                      1, smem};
    }
  }
  const int threads = std::min(kThreads, (D + 31) / 32 * 32);
  return {(const void*)rmsnorm_bwd_general_kernel<T>, threads, 1, 0};
}

// resident blocks an SM for the plan (0 if it cannot launch)
cudaError_t plan_occupancy(const Plan& p, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, p.kernel,
                                                       p.threads, p.smem);
}

template <typename T>
cudaError_t launch_bwd(BwdArgs a, int max_blocks, cudaStream_t stream) {
  const bool aligned = aligned16(a.x) && aligned16(a.scale) &&
                       aligned16(a.dy) && aligned16(a.dx);
  const Plan p = bwd_plan<T>(a.D, aligned);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = plan_occupancy(p, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the fewest blocks that take the rows in as few rounds as the most
  // blocks would: every block walks the same number of rows, or one less
  const int64_t most = std::min<int64_t>(
      (int64_t)std::min(per_sm, kBwdBlocksPerSM) * sms, max_blocks);
  const int64_t rounds = (a.rows + most - 1) / most;
  const int64_t nb = (a.rows + rounds - 1) / rounds;
  void* args[] = {&a.x,       &a.scale, &a.dy,   &a.dx, &a.partial,
                  &a.dscale,  &a.bar,   &a.rows, &a.D,  &a.eps};
  e = cudaLaunchCooperativeKernel(p.kernel, dim3((unsigned)nb),
                                  dim3(p.threads), args, p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// registers, local bytes, dynamic shared memory and resident blocks an SM
cudaError_t plan_attrs(const Plan& p, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, p.kernel);
  if (e == cudaSuccess) e = plan_occupancy(p, &out[3]);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)p.smem;
  return e;
}

template <typename T>
Plan plan_for(int bwd, int D) {
  constexpr int kVec = 16 / sizeof(T);
  if (bwd) return bwd_plan<T>(D, true);
  return D % kVec == 0 ? fwd_plan<T, kVec>(D) : fwd_plan<T, 1>(D);
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
      return dispatch_fwd<float>(x, scale, out, rows, D, eps, s);
    case REPRO_BF16:
      return dispatch_fwd<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, dy, dx: (rows, D) contiguous of one dtype; scale: (D,) of that dtype;
// partial: fp32 scratch (max_blocks, D); dscale: fp32 (D,), all written;
// bar: a zeroed counter no other launch uses at the same time (its low
// bits are back to 0 when the launch ends).  One cooperative launch of at
// most max_blocks blocks.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* partial, void* dscale, void* bar,
                           long long rows, int D, int max_blocks, float eps,
                           int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  const BwdArgs a{x,     scale, dy, dx, static_cast<float*>(partial),
                  static_cast<float*>(dscale),
                  static_cast<unsigned int*>(bar), rows, D, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return launch_bwd<float>(a, max_blocks, s);
    case REPRO_BF16: return launch_bwd<__nv_bfloat16>(a, max_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// The most backward blocks an SM: the wrapper's partial rows, per SM.
extern "C" int rmsnorm_bwd_blocks_per_sm() { return kBwdBlocksPerSM; }

// Registers, local (spill) bytes, dynamic shared memory and resident
// blocks an SM of the kernel that serves a row of D in `dtype` with
// 16-byte aligned tensors: the forward (bwd 0) or the backward (bwd 1).
extern "C" int rmsnorm_attrs(int bwd, int D, int dtype, int* out) {
  if (D <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case REPRO_F32: return plan_attrs(plan_for<float>(bwd, D), out);
    case REPRO_BF16: return plan_attrs(plan_for<__nv_bfloat16>(bwd, D), out);
    default: return cudaErrorInvalidValue;
  }
}
