// Fused multi-tap lattice stencil apply for Hopper (sm_90a), 2-D and 3-D.
//
// Replaces the Pallas kernel pdebench_tpu/solvers/stencil_pallas.py
// (`stencil_apply_2d`, kernel body `_kernel`):
//
//     y[z, r, c] = sum_k W[k, z, r, c] *
//                  u_pad[z + pz + dz_k, r + p + dy_k, c + p + dx_k]
//
// with u_pad of shape (nz + 2 pz, ny + 2 p, nx + 2 p), W of shape (K, nz,
// ny, nx), y of shape (nz, ny, nx), all row-major and contiguous, in float
// or double. A 2-D lattice is nz = 1 with pz = 0 and dz = 0; a 3-D one has
// pz = p. The reference applies 3-D stencils in XLA
// (pdebench_tpu/solvers/stencil.py:744-753), where a PyTorch apply would
// take two launches per tap (130 for a 3-D P2 stencil).
//
// What bounds it: memory traffic and launch latency. One call reads the K
// weight planes and the padded field once and writes y once: K + 2 planes
// (about 0.9 MB in double for a 121 x 121 lattice with K = 7), a few
// microseconds at HBM bandwidth, the order of one kernel launch. There is
// no reuse beyond the K taps of u_pad, which neighbouring threads share
// through L1. In 3-D the weights dominate: 65 planes of a 33^3 lattice are
// 18.7 MB in double, ~6 us at HBM bandwidth.
//
// Design: one thread per output point, 32 x 8 blocks with x fastest and
// one block row per z-plane, so a warp reads 32 consecutive addresses of
// every weight plane and of each tap's row of u_pad. The taps travel in
// the kernel's parameter block (no global state), up to 128 of them (a
// 3-D P2 stencil has 65). Taps are summed in order k = 0..K-1, the order
// of the plain PyTorch version; the compiler fuses each multiply-add,
// which rounds once where the plain version rounds twice.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 128;

struct Taps {
  int K;
  signed char dz[kMaxTaps];
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
};

template <typename T>
__global__ void __launch_bounds__(256)
stencil_apply_kernel(const T* __restrict__ u_pad, const T* __restrict__ W,
                     T* __restrict__ y, int nz, int ny, int nx, int pad,
                     int pad_z, Taps taps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (r >= ny || c >= nx) return;
  const long long nxp = nx + 2 * pad, nyp = ny + 2 * pad;
  const long long vol = (long long)nz * ny * nx;
  const long long idx = ((long long)z * ny + r) * nx + c;
  T acc = T(0);
  for (int k = 0; k < taps.K; ++k) {
    const long long src =
        ((long long)(z + pad_z + taps.dz[k]) * nyp + (r + pad + taps.dy[k])) * nxp +
        (c + pad + taps.dx[k]);
    acc += W[k * vol + idx] * u_pad[src];
  }
  y[idx] = acc;
}

template <typename T>
int launch(const T* u_pad, const T* W, T* y, int nz, int ny, int nx, int pad,
           int pad_z, int K, const int* offs, void* stream) {
  if (K < 0 || K > kMaxTaps || nz <= 0 || nz > 65535 || ny <= 0 || nx <= 0 ||
      pad < 0 || pad > 127 || pad_z < 0 || pad_z > pad)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.K = K;
  for (int k = 0; k < K; ++k) {
    const int dz = offs[3 * k], dy = offs[3 * k + 1], dx = offs[3 * k + 2];
    if (dz < -pad_z || dz > pad_z || dy < -pad || dy > pad || dx < -pad ||
        dx > pad)
      return (int)cudaErrorInvalidValue;
    taps.dz[k] = (signed char)dz;
    taps.dy[k] = (signed char)dy;
    taps.dx[k] = (signed char)dx;
  }
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y, nz);
  stencil_apply_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      u_pad, W, y, nz, ny, nx, pad, pad_z, taps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// offs: host array of 3*K ints, (dz, dy, dx) per tap; pad_z is 0 for a
// 2-D lattice (nz = 1), pad for a 3-D one. Returns a cudaError_t.
int stencil_apply_f32(const float* u_pad, const float* W, float* y, int nz,
                      int ny, int nx, int pad, int pad_z, int K,
                      const int* offs, void* stream) {
  return launch<float>(u_pad, W, y, nz, ny, nx, pad, pad_z, K, offs, stream);
}

int stencil_apply_f64(const double* u_pad, const double* W, double* y, int nz,
                      int ny, int nx, int pad, int pad_z, int K,
                      const int* offs, void* stream) {
  return launch<double>(u_pad, W, y, nz, ny, nx, pad, pad_z, K, offs, stream);
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
