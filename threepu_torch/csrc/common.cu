// C entry points the whole kernel library shares.
#include <cuda_runtime.h>

// The message of a cudaError_t that an entry point returned.
extern "C" const char* threepu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
