// Fused multi-tap 2-D lattice stencil apply for Hopper (sm_90a).
//
// Replaces the Pallas kernel pdebench_tpu/solvers/stencil_pallas.py
// (`stencil_apply_2d`, kernel body `_kernel`):
//
//     y[r, c] = sum_k W[k, r, c] * u_pad[r + p + dy_k, c + p + dx_k]
//
// with u_pad of shape (ny + 2p, nx + 2p), W of shape (K, ny, nx), y of
// shape (ny, nx), all row-major and contiguous, in float or double.
//
// What bounds it: memory traffic and launch latency. One call reads the K
// weight planes and the padded field once and writes y once: K + 2 planes
// (about 0.9 MB in double for a 121 x 121 lattice with K = 7), a few
// microseconds at HBM bandwidth, the order of one kernel launch. There is
// no reuse beyond the K taps of u_pad, which neighbouring threads share
// through L1.
//
// Design: one thread per output point, 32 x 8 blocks with x fastest, so a
// warp reads 32 consecutive addresses of every weight plane and of each
// tap's row of u_pad. The taps travel in the kernel's parameter block (no
// global state), up to 64 of them. Taps are summed in order k = 0..K-1,
// the order of the plain PyTorch version; the compiler fuses each
// multiply-add, which rounds once where the plain version rounds twice.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

struct Taps {
  int K;
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
};

template <typename T>
__global__ void __launch_bounds__(256)
stencil_apply_kernel(const T* __restrict__ u_pad, const T* __restrict__ W,
                     T* __restrict__ y, int ny, int nx, int pad, Taps taps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= ny || c >= nx) return;
  const long long nxp = nx + 2 * pad;
  const long long plane = (long long)ny * nx;
  const long long idx = (long long)r * nx + c;
  T acc = T(0);
  for (int k = 0; k < taps.K; ++k) {
    const long long src = (long long)(r + pad + taps.dy[k]) * nxp +
                          (c + pad + taps.dx[k]);
    acc += W[k * plane + idx] * u_pad[src];
  }
  y[idx] = acc;
}

template <typename T>
int launch(const T* u_pad, const T* W, T* y, int ny, int nx, int pad, int K,
           const int* offs, void* stream) {
  if (K < 0 || K > kMaxTaps || ny <= 0 || nx <= 0 || pad < 0 || pad > 127)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.K = K;
  for (int k = 0; k < K; ++k) {
    const int dy = offs[2 * k], dx = offs[2 * k + 1];
    if (dy < -pad || dy > pad || dx < -pad || dx > pad)
      return (int)cudaErrorInvalidValue;
    taps.dy[k] = (signed char)dy;
    taps.dx[k] = (signed char)dx;
  }
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  stencil_apply_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      u_pad, W, y, ny, nx, pad, taps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// offs: host array of 2*K ints, (dy, dx) per tap. Returns a cudaError_t.
int stencil_apply_2d_f32(const float* u_pad, const float* W, float* y, int ny,
                         int nx, int pad, int K, const int* offs,
                         void* stream) {
  return launch<float>(u_pad, W, y, ny, nx, pad, K, offs, stream);
}

int stencil_apply_2d_f64(const double* u_pad, const double* W, double* y,
                         int ny, int nx, int pad, int K, const int* offs,
                         void* stream) {
  return launch<double>(u_pad, W, y, ny, nx, pad, K, offs, stream);
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
