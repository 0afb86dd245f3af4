// The CUDA runtime's message for an error code that a kernel entry point of
// this library returned, for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* igcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
