// Richardson chain of block (d = 2) V-cycles on a hierarchy whose weights
// are the call's tensors, in one launch of one thread-block cluster, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_dyn_block_vcycle` (pl.pallas_call at :934; kernel body
// `_kernel`, :851-907): the velocity-block preconditioner of the
// Navier-Stokes Newton saddle FGMRES, on the hierarchy Galerkin-coarsened
// from each Newton step's convected Jacobian (gmg_dyn.build_levels).
//
//   z = V(r), then cycles - 1 times z += V(r - A0 z)
//
// V is the block V-cycle of gmg_block_vcycle.cuh on the spec's levels,
// run on a cluster (gmg_cluster.cuh's vcycle2_to_fine_cl; pure halving,
// 2-D); its coarsest level is the spec's last, swept
// kCoarseSweeps times (no probed extra level, unlike kernels #2 and #4).
// D carries the level's omega. A tap outside a level reads zero (the
// Pallas kernel's rolls over zero-padded planes; here bounds checks).
//
// What differs from kernel #4's Richardson mode: every level's W (K, 2,
// 2, ny, nx) and D (2, 2, ny, nx) change at every Newton step, so the
// descriptor (level pointers, shapes, taps) is packed once per weight set
// (per build_levels), not per hierarchy, and the wrapper keeps it with the
// tensors it points at. r and z are read and written in the lattice's
// site-major (ny, nx, 2) layout inside the first and last stages, so a
// call makes no layout copies; the chain's running sum lives in a planar
// work vector. A one-level spec (a fine level at or below the spec's
// coarse size) is the coarsest sweeps alone.
//
// What bounds it: latency of dependent stages. navier_stokes_basic's
// hierarchy (97/49/25/13, 19 fine taps, 25 coarse) is ~4 MB and stays in
// the 50 MB L2, but each of the 13 stages of a V-cycle needs the whole
// previous one. The cooperative design this replaced (37 blocks of 256
// threads, grid barriers) took 0.14 ms a call on an H100 80GB HBM3 at 700
// W, half of it the
// one-block coarsest sweep reading its 13^2 level from L2 (65 us), the
// rest 4-9 us stages of dependent L2 loads (PERF.md, stage stamps). So
// (gmg_cluster.cuh): one cluster of up to 16 CTAs x 1,024 threads is the
// whole launch, stages separated by the hardware cluster barrier; each CTA
// owns a band of rows of every level, copies the zero-padded box of a tap
// stage's input vector its band reaches into shared memory first, reads
// it without bounds checks and issues each site's block-tap loads
// together; the coarse stage restricts into the
// coarsest level and sweeps it 10 times in one CTA's shared memory (its
// W and D, 67 KB at 13^2 x 25 taps, copied in each time). The per-site
// sums are those of gmg_block_vcycle.cuh, in the same order.

#include "gmg_cluster.cuh"

namespace {

struct DynHier {
  Level lv[kMaxLevels];  // block levels: the call's W and D, work r, x, t
  Taps T[kMaxLevels];    // each level's taps in its windows
  float* zp;             // the chain's running sum, planar (2, ny, nx)
  int nlev;
};

// The V-cycle of H.lv[0].r (with H.lv[0].x = D0 r set) at fine site idx,
// after vcycle2_to_fine_cl: the post-smoothed value (x the window of
// lv[0].x, w its weights), or on a one-level hierarchy the coarsest
// sweeps' result
template <class WS>
__device__ __forceinline__ void vcycle_at(const DynHier& H, const Window& x, WS w, int idx,
                                          float& v0, float& v1) {
  const Level& L0 = H.lv[0];
  if (H.nlev == 1) {
    const int n = L0.ny * L0.nx;
    v0 = ldw(L0.t + idx);
    v1 = ldw(L0.t + n + idx);
  } else {
    const int p = x.site(L0, idx);
    smooth2_win(L0, H.T[0], w, x.s + p, x.s + x.plane + p, idx, v0, v1);
  }
}

__global__ void __launch_bounds__(kClusterThreads, 1)
gmg_fused_dyn_block_kernel(const DynHier* __restrict__ desc,
                           const float* __restrict__ r_in, float* z,
                           int cycles) {
  cg::cluster_group cluster = cg::this_cluster();
  float* sm = cluster_smem;  // windows, coarse level
  __shared__ DynHier H;
  {
    const int* src = reinterpret_cast<const int*>(desc);
    int* dst = reinterpret_cast<int*>(&H);
    for (int i = threadIdx.x; i < (int)(sizeof(DynHier) / sizeof(int));
         i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();

  const Level& L0 = H.lv[0];
  const int n0 = L0.ny * L0.nx;
  const Band b = band(L0);
  float* zp = H.zp;
  // the band whose window of level 0's x the final stages read (none on a
  // one-level hierarchy)
  const Band bx = H.nlev > 1 ? b : Band{0, 0};

  // r (site-major) -> level 0's planar rhs, x = D0 r
  for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x)
    set_rhs2(L0, idx, r_in[2 * idx], r_in[2 * idx + 1]);
  cluster.sync();
  for (int c = 0; c < cycles - 1; ++c) {
    vcycle2_to_fine_cl(H.lv, H.T, H.nlev, sm, cluster);
    {
      const Window x = stage_in(L0.x, L0, H.T[0], bx, 2, sm);
      const GlobalW w{L0.W, n0};
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
        float s0, s1;
        vcycle_at(H, x, w, idx, s0, s1);
        zp[idx] = c == 0 ? s0 : ldw(zp + idx) + s0;
        zp[n0 + idx] = c == 0 ? s1 : ldw(zp + n0 + idx) + s1;
      }
    }
    cluster.sync();
    {
      const Window zw = stage_in(zp, L0, H.T[0], b, 2, sm);
      const GlobalW w{L0.W, n0};
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
        const int p = zw.site(L0, idx);
        float a0, a1;
        taps2_at(L0, H.T[0].woff, w, zw.s + p, zw.s + zw.plane + p, idx, a0, a1);
        set_rhs2(L0, idx, r_in[2 * idx] - a0, r_in[2 * idx + 1] - a1);
      }
    }
    cluster.sync();
  }
  vcycle2_to_fine_cl(H.lv, H.T, H.nlev, sm, cluster);
  const Window x = stage_in(L0.x, L0, H.T[0], bx, 2, sm);
  const GlobalW w{L0.W, n0};
  for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
    float s0, s1;
    vcycle_at(H, x, w, idx, s0, s1);
    z[2 * idx] = cycles > 1 ? ldw(zp + idx) + s0 : s0;
    z[2 * idx + 1] = cycles > 1 ? ldw(zp + n0 + idx) + s1 : s1;
  }
}

// Dynamic shared memory of a CTA over a cluster of P: the larger of its
// windows (two component planes) and the coarsest level's copy.
int smem_bytes(const DynHier& H, int P) {
  const int area = window_floats(H.lv, H.T, H.nlev, 2, P);
  const int coarse = coarse2_floats(H.lv[H.nlev - 1], H.T[H.nlev - 1]);
  return (int)sizeof(float) * (coarse > area ? coarse : area);
}

}  // namespace

extern "C" {

int gmg_fused_dyn_block_desc_bytes() { return (int)sizeof(DynHier); }

// Fill a host buffer of gmg_fused_dyn_block_desc_bytes() bytes with the
// block level descriptors of one weight set (ptrs, dims, offs as
// pack_levels takes them: W and D the set's planar tensors, r, x, t work
// vectors (2, ny, nx)) and the chain's planar running sum zp. One level
// or more, 2-D.
int gmg_fused_dyn_block_pack(void* out, int nlev, const long long* ptrs,
                             const int* dims, const int* offs, long long zp) {
  DynHier* H = static_cast<DynHier*>(out);
  *H = DynHier{};
  const int e = pack_levels(H->lv, nlev, ptrs, dims, offs, 1);
  if (e != 0) return e;
  for (int l = 0; l < nlev; ++l) {  // 2-D block levels only
    if (H->lv[l].nz != 1) return (int)cudaErrorInvalidValue;
    window_taps(H->lv[l], H->T[l]);
  }
  H->zp = reinterpret_cast<float*>(zp);
  H->nlev = nlev;
  return 0;
}

// The cluster size and dynamic shared memory of a packed descriptor
// (host copy; the same for every weight set of a spec) on the current
// device; an error if no cluster of 8 or 16 CTAs with that memory can be
// resident.
int gmg_fused_dyn_block_config(const void* desc, int* cluster, int* smem) {
  const DynHier& H = *static_cast<const DynHier*>(desc);
  return cluster_config(gmg_fused_dyn_block_kernel, [&](int P) { return smem_bytes(H, P); },
                        cluster, smem);
}

// z = the chain of `cycles` block V-cycles on r; r and z (ny, nx, 2)
// site-major. desc: a packed descriptor in device memory; cluster and
// smem from gmg_fused_dyn_block_config.
int gmg_fused_dyn_block_launch(const void* desc, const float* r, float* z,
                               int cycles, int cluster, int smem, void* stream) {
  if (cycles < 1) return (int)cudaErrorInvalidValue;
  return cluster_launch(gmg_fused_dyn_block_kernel, cluster, smem, stream,
                        static_cast<const DynHier*>(desc), r, z, cycles);
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
