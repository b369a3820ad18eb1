// Names a cudaError_t returned by the launch entry points.
#include <cuda_runtime.h>

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
