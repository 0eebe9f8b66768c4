// Error strings for the wrappers in kernels/build.py.
#include "common.cuh"

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
