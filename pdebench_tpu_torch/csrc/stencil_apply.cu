// Multi-tap lattice stencil apply for Hopper (sm_90a): scalar, d = 2 and
// d = 3 block stencils on 2-D and 3-D lattices, one launch per apply.
//
// Replaces the Pallas kernel pdebench_tpu/solvers/stencil_pallas.py
// (`stencil_apply_2d`, kernel body `_kernel`) and the reference's XLA
// applies that have no Pallas kernel: 3-D scalar lattices
// (pdebench_tpu/solvers/stencil.py:744-753), block lattices (:857-869)
// and the Navier-Stokes weight map (:658-669):
//
//     scalar: y[s]    = sum_k W[k, s] * u[s + o_k]
//     block:  y[s, a] = sum_b sum_k W[k, s, a, b] * u[s + o_k, b]
//
// zero outside the lattice. u and y have the lattice's own shape (nz, ny,
// nx), interleaved (nz, ny, nx, d) for a block stencil; W is (K, nz, ny,
// nx) or (K, nz, ny, nx, d, d); all row-major and contiguous, float or
// double. A 2-D lattice is nz = 1 with dz = 0.
//
// What bounds it: bytes and launch latency. A call reads W once (K planes,
// d^2 K for a block stencil), u and writes y: K + 2 planes, about 0.9 MB in
// double for a 121^2 lattice with K = 7, a few microseconds at HBM rate,
// the order of one launch. There is no reuse beyond the taps of u, which
// neighbouring threads share through L1. So the design cuts what the
// caller pays around the kernel and keeps every lane busy:
//  - one launch per apply, from a plan the wrapper packed once per
//    operator (stencil_kernel.StencilPlan): the lattice's sizes and each
//    tap's (dz, dy, dx) and flat offset, passed by value in the kernel's
//    parameter block (up to 128 taps; a 3-D P2 stencil has 65);
//  - u unpadded: no pad launch or copy. A warp whose sites all lie
//    beyond every tap's reach of an edge runs a branch-free loop over flat
//    offsets; any other warp tests each tap's source against the lattice
//    (one loop for the whole warp: no divergence between the two);
//  - the plan is a __grid_constant__ parameter: the taps are read from
//    the constant bank by index, with no per-thread copy of the struct;
//  - on 2-D lattices a flat grid: one thread per site over the flattened
//    index, 256-thread blocks, so a warp reads 32 consecutive words of
//    every weight plane and a narrow row leaves no lane idle (3-D
//    stencils reaching more than kReach sites take it too);
//  - on 3-D lattices (taps reaching at most 2) a tile per block: 2 x 4 x
//    32 sites, whose u with its halo a block copies into shared memory by
//    cp.async (zeros outside the lattice), so no tap is tested against an
//    edge; the flat kernel took 13.3 us a 33^3 f64 apply on the H100
//    against this one's 8.4 (every warp of a 33-wide row holds edge sites
//    and took the tested loop; PERF.md §6);
//  - a d = 2 block stencil in one launch: one thread computes both
//    components of a site, reading W[k, s, :, :] as one 16-byte load (f32)
//    or two (f64) and u[s + o_k, :] as one 8- or 16-byte load, and writes
//    y[s, :] interleaved;
//  - a d = 3 block stencil (3-D Taylor-Hood velocity blocks) in one
//    launch: a site's 3 values are 12 or 24 bytes, which no vector load
//    takes aligned, so one thread computes one row (s, a) of a site with
//    scalar loads: W[k, s, a, :] (a warp reads ~96 consecutive words of a
//    tap's weights) and u[s + o_k, :] (the 3 threads of a site read the
//    same words); 128-thread blocks, so a 17^3 lattice spreads over 116
//    blocks.
// Rounding is fixed with explicit fused multiply-adds: the scalar form
// sums k = 0..K-1 into one accumulator; the block forms sum each (a, b)
// coupling over k, then add b = 0, 1 (, 2) in order. The plain versions
// (stencil_kernel.stencil_plain / block_stencil_plain) sum in the same
// orders with the products rounded apart.
// Tensor cores do not apply (no arithmetic intensity), nor do copy rings
// of W (read once, no reuse to stage).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 128;
constexpr int kThreads = 256;

// struct of stencil_kernel.StencilPlan's packed int32 buffer: n = nz ny
// nx, the per-axis reach (pz, py, px), each tap's flat offset and
// (dz, dy, dx)
struct Plan {
  int n, nz, ny, nx, K, pz, py, px;
  int off[kMaxTaps];
  signed char dz[kMaxTaps], dy[kMaxTaps], dx[kMaxTaps];
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// a site and whether every tap of it lands inside the lattice
struct Site {
  int s, z, r, c;
  bool interior;
};

__device__ __forceinline__ Site site_of(const Plan& p, int s) {
  Site q;
  q.s = s;
  q.c = s % p.nx;
  const int t = s / p.nx;
  q.r = t % p.ny;
  q.z = t / p.ny;
  q.interior = q.c >= p.px && q.c < p.nx - p.px && q.r >= p.py && q.r < p.ny - p.py &&
               q.z >= p.pz && q.z < p.nz - p.pz;
  return q;
}

__device__ __forceinline__ bool tap_inside(const Plan& p, const Site& q, int k) {
  const int z = q.z + p.dz[k], r = q.r + p.dy[k], c = q.c + p.dx[k];
  return z >= 0 && z < p.nz && r >= 0 && r < p.ny && c >= 0 && c < p.nx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_scalar(const T* __restrict__ u, const T* __restrict__ W, T* __restrict__ y,
               const __grid_constant__ Plan p) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.n) return;
  const Site q = site_of(p, s);
  const T* w = W + s;
  T acc = T(0);
  if (__all_sync(__activemask(), q.interior)) {
    for (int k = 0; k < p.K; ++k, w += p.n)
      acc = fma_rn(__ldg(w), __ldg(u + s + p.off[k]), acc);
  } else {
    for (int k = 0; k < p.K; ++k, w += p.n)
      if (tap_inside(p, q, k)) acc = fma_rn(__ldg(w), __ldg(u + s + p.off[k]), acc);
  }
  y[s] = acc;
}

// 2 x 2 weight block and 2-vector loads, 16 / 8 bytes (f32) or 32 / 16
// bytes (f64) a site, aligned (the wrapper checks the pointers)
__device__ __forceinline__ void load_block(const float* w, float v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_block(const double* w, double v[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(w));
  const double2 b = __ldg(reinterpret_cast<const double2*>(w) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load_pair(const float* u, float v[2]) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(u));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load_pair(const double* u, double v[2]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(u));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store_pair(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(double* y, double a, double b) {
  *reinterpret_cast<double2*>(y) = make_double2(a, b);
}

// acc[2 a + b] += W[k, s, a, b] u[s + o_k, b]
template <typename T>
__device__ __forceinline__ void block_tap(const T* w, const T* u, T acc[4]) {
  T wv[4], uv[2];
  load_block(w, wv);
  load_pair(u, uv);
  acc[0] = fma_rn(wv[0], uv[0], acc[0]);
  acc[1] = fma_rn(wv[1], uv[1], acc[1]);
  acc[2] = fma_rn(wv[2], uv[0], acc[2]);
  acc[3] = fma_rn(wv[3], uv[1], acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_block2(const T* __restrict__ u, const T* __restrict__ W, T* __restrict__ y,
               const __grid_constant__ Plan p) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.n) return;
  const Site q = site_of(p, s);
  const T* w = W + 4 * (size_t)s;
  const size_t step = 4 * (size_t)p.n;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  if (__all_sync(__activemask(), q.interior)) {
    for (int k = 0; k < p.K; ++k, w += step) block_tap(w, u + 2 * (s + p.off[k]), acc);
  } else {
    for (int k = 0; k < p.K; ++k, w += step)
      if (tap_inside(p, q, k)) block_tap(w, u + 2 * (s + p.off[k]), acc);
  }
  store_pair(y + 2 * (size_t)s, acc[0] + acc[1], acc[2] + acc[3]);
}

// d = 3 block stencils: thread t takes row a = t % 3 of site s = t / 3,
// acc[b] += W[k, s, a, b] u[s + o_k, b] over k, then y[s, a] = (acc[0] +
// acc[1]) + acc[2]
constexpr int kThreads3 = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads3)
stencil_block3(const T* __restrict__ u, const T* __restrict__ W, T* __restrict__ y,
               const __grid_constant__ Plan p) {
  const int t = blockIdx.x * kThreads3 + threadIdx.x;
  if (t >= 3 * p.n) return;
  const Site q = site_of(p, t / 3);
  const T* w = W + 3 * (size_t)t;
  const size_t step = 9 * (size_t)p.n;
  T acc[3] = {T(0), T(0), T(0)};
  if (__all_sync(__activemask(), q.interior)) {
    for (int k = 0; k < p.K; ++k, w += step) {
      const T* v = u + 3 * (q.s + p.off[k]);
#pragma unroll
      for (int b = 0; b < 3; ++b) acc[b] = fma_rn(__ldg(w + b), __ldg(v + b), acc[b]);
    }
  } else {
    for (int k = 0; k < p.K; ++k, w += step) {
      if (!tap_inside(p, q, k)) continue;
      const T* v = u + 3 * (q.s + p.off[k]);
#pragma unroll
      for (int b = 0; b < 3; ++b) acc[b] = fma_rn(__ldg(w + b), __ldg(v + b), acc[b]);
    }
  }
  y[t] = (acc[0] + acc[1]) + acc[2];
}

// 3-D scalar lattices, taps reaching at most kReach: a block takes a
// kTZ x kTY x kTX tile of sites, copies the tile of u with its halo into
// shared memory by cp.async (zero outside the lattice), then sums every
// tap from there in order; W comes through L1 as in the flat kernel. A tap
// outside the lattice adds fma(W, 0, acc) = acc: the flat kernel's sum.
constexpr int kTX = 32, kTY = 4, kTZ = 2, kReach = 2;
constexpr int kHX = kTX + 2 * kReach, kHY = kTY + 2 * kReach, kHZ = kTZ + 2 * kReach;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_tiled(const T* __restrict__ u, const T* __restrict__ W, T* __restrict__ y,
              const __grid_constant__ Plan p) {
  __shared__ T tile[kHZ * kHY * kHX];
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY, z0 = blockIdx.z * kTZ;
  for (int q = threadIdx.x; q < kHZ * kHY * kHX; q += kThreads) {
    const int hx = q % kHX, hy = (q / kHX) % kHY, hz = q / (kHX * kHY);
    const int c = x0 + hx - kReach, r = y0 + hy - kReach, z = z0 + hz - kReach;
    if (z >= 0 && z < p.nz && r >= 0 && r < p.ny && c >= 0 && c < p.nx) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(tile + q);
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                   "l"(u + ((size_t)z * p.ny + r) * p.nx + c), "n"(sizeof(T)));
    } else {
      tile[q] = T(0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int tx = threadIdx.x % kTX, ty = (threadIdx.x / kTX) % kTY, tz = threadIdx.x / (kTX * kTY);
  const int c = x0 + tx, r = y0 + ty, z = z0 + tz;
  if (c >= p.nx || r >= p.ny || z >= p.nz) return;
  const int s = (z * p.ny + r) * p.nx + c;
  const T* h = tile + ((tz + kReach) * kHY + ty + kReach) * kHX + tx + kReach;
  const T* w = W + s;
  T acc = T(0);
  for (int k = 0; k < p.K; ++k, w += p.n)
    acc = fma_rn(__ldg(w), h[(p.dz[k] * kHY + p.dy[k]) * kHX + p.dx[k]], acc);
  y[s] = acc;
}

enum Kind { kFlat, kBlock2, kBlock3, kTiled };

template <typename T, Kind kKind>
int launch(const T* u, const T* W, T* y, const void* plan, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.n <= 0 || p.K < 0 || p.K > kMaxTaps) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kKind == kTiled) {
    if (p.pz > kReach || p.py > kReach || p.px > kReach) return (int)cudaErrorInvalidValue;
    const dim3 grid((p.nx + kTX - 1) / kTX, (p.ny + kTY - 1) / kTY, (p.nz + kTZ - 1) / kTZ);
    stencil_tiled<T><<<grid, kThreads, 0, st>>>(u, W, y, p);
  } else if (kKind == kBlock3) {
    const int blocks = (3 * p.n + kThreads3 - 1) / kThreads3;
    stencil_block3<T><<<blocks, kThreads3, 0, st>>>(u, W, y, p);
  } else {
    const int blocks = (p.n + kThreads - 1) / kThreads;
    if (kKind == kBlock2)
      stencil_block2<T><<<blocks, kThreads, 0, st>>>(u, W, y, p);
    else
      stencil_scalar<T><<<blocks, kThreads, 0, st>>>(u, W, y, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u, W, y: device pointers; plan: host pointer to the packed Plan;
// stream: a cudaStream_t. Returns a cudaError_t.
int stencil_apply_f32(const float* u, const float* W, float* y, const void* plan, void* stream) {
  return launch<float, kFlat>(u, W, y, plan, stream);
}

int stencil_apply_f64(const double* u, const double* W, double* y, const void* plan,
                      void* stream) {
  return launch<double, kFlat>(u, W, y, plan, stream);
}

int stencil_apply_3d_f32(const float* u, const float* W, float* y, const void* plan,
                         void* stream) {
  return launch<float, kTiled>(u, W, y, plan, stream);
}

int stencil_apply_3d_f64(const double* u, const double* W, double* y, const void* plan,
                         void* stream) {
  return launch<double, kTiled>(u, W, y, plan, stream);
}

int stencil_apply_block2_f32(const float* u, const float* W, float* y, const void* plan,
                             void* stream) {
  return launch<float, kBlock2>(u, W, y, plan, stream);
}

int stencil_apply_block2_f64(const double* u, const double* W, double* y, const void* plan,
                             void* stream) {
  return launch<double, kBlock2>(u, W, y, plan, stream);
}

int stencil_apply_block3_f32(const float* u, const float* W, float* y, const void* plan,
                             void* stream) {
  return launch<float, kBlock3>(u, W, y, plan, stream);
}

int stencil_apply_block3_f64(const double* u, const double* W, double* y, const void* plan,
                             void* stream) {
  return launch<double, kBlock3>(u, W, y, plan, stream);
}

int stencil_plan_bytes() { return (int)sizeof(Plan); }

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
