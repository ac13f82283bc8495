// The text of a CUDA error code, for the Python wrappers' messages
// (``_build.check``): every C entry returns a cudaError_t as an int.
#include <cuda_runtime.h>

extern "C" const char* dlpd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
