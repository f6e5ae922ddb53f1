// CUDA error text for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
