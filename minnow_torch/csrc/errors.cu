// The CUDA runtime's text for an error code the kernels' entry points
// returned, for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* minnow_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
