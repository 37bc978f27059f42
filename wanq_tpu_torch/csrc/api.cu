// Error reporting for the ctypes bindings: every entry point returns a
// cudaError_t; the Python side turns a non-zero code into a message here.
#include "common.cuh"

WANQ_API const char* wanq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
