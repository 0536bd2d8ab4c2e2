// The CUDA runtime's message for an error code returned by a kernel entry
// point, for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* bwma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
