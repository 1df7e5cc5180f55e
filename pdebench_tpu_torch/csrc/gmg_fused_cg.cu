// Whole GMG-preconditioned inner solve in one launch of one thread-block
// cluster, for Hopper (sm_90a). Two modes, one kernel:
//
// mode 0, cg: replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_inner_cg` (mode "cg", pl.pallas_call at :434; kernel body
// `_kernel`, hierarchy from `_scalar_hierarchy`), 2-D and 3-D scalar
// lattices (the 3-D form: the slab-packed `_Level3` levels, :110-168). It
// runs `iters` PCG steps in float on a lattice residual r and writes the
// correction z:
//
//   z = 0, res = r, p = s = V(res), rz = <res, s>
//   repeat iters times:
//     Ap = A0 p;  alpha = rz / <p, Ap>     (denominator 1 where it is 0)
//     z += alpha p;  res -= alpha Ap
//     s = V(res);  rz' = <res, s>;  beta = rz' / rz  (1 where rz is 0)
//     p = s + beta p;  rz = rz'
//
// (the last step's V-cycle and p update do not reach z and are not run).
//
// mode 1, richardson: replaces the same pl.pallas_call in mode
// "richardson" (`build_fused_richardson`, gmg_fused.py:461-472; body
// :378-384): a chain of `iters` V-cycles, z = V(r), then iters - 1 times
// z += V(r - A0 z), with A0 the hierarchy's level 0. Linear in r, so it
// preconditions the non-flexible GMRES inner of the refinement.
//
// V is one multigrid V-cycle over the hierarchy (gmg_cluster.cuh).
//
// What bounds it: latency of dependent stages, not bandwidth or
// arithmetic. The hierarchy of a 121 x 121 P1 lattice is 0.7 MB, of a
// 241 x 241 P3 one 10.7 MB: it stays in the 50 MB L2, but every stage of
// a V-cycle needs the whole previous stage. On an H100 80GB HBM3 at 700 W
// the cooperative design this replaced (one launch of 58-227 blocks, a
// grid barrier between stages, the coarsest level swept by one block from
// L2) spent 27-160 us per V-cycle in that one-block sweep, 36-57% of the
// call, and 2.5-22 us in each other stage (PERF.md, stage stamps).
// So this design, on gmg_cluster.cuh's stages:
// - one cluster of up to 16 CTAs x 1,024 threads is the whole launch, its
//   stages separated by the hardware cluster barrier; each CTA owns a band
//   of rows of every level and reads the taps' inputs from zero-padded
//   windows in shared memory;
// - CTA 0 solves the coarse levels from l* down in its shared memory: in
//   3-D every level that fits (9^3 and 5^3 of a 33^3 P2 hierarchy, the
//   probed 8^3 of a 29^3 one), in 2-D the coarsest (16^2 of a 121^2 P1
//   hierarchy; cta_first_level); their W and D are copied in once per
//   launch, and the coarse stage restricts into level l* and runs those
//   levels' V-cycle on block barriers;
// - the PCG dots are CTA partials in shared-memory slots, summed in
//   double across the cluster through distributed shared memory in a
//   fixed order (cluster_total): every CTA holds the same alpha and beta,
//   deterministically and without atomics;
// - p = s + beta p is not a stage of its own: the stage of Ap = A0 p
//   builds its window of p from s and the previous p (band and halo) and
//   writes p at its own sites into the other of two p buffers, so no CTA
//   overwrites a value a neighbour still reads.
// - in 2-D a restriction is computed on the window of the stage that
//   takes the coarse level's residual and a prolongation on the window of
//   the stage that post-smooths, so neither is a stage of its own (a 3-D
//   window holds whole pad planes around a band of one to three planes:
//   there each transfer stays a stage, transfer_on_window).
// Cluster barriers: per PCG step 2 l* + 3 in 2-D (Ap with <p, Ap>; z,
// res and x = D res; the V-cycle's 2 l*; level 0's prolongation and
// post-smoothing with <res, s>), 9 on a 4-level P1 hierarchy (l* = 3)
// against the cooperative design's 16, and 4 l* + 2 in 3-D; per V-cycle
// of the chain 2 more (z's update and r - A0 z). The vector updates round
// as the plain version does (products, then sums; no fused multiply-add).
// What this costs: one cluster has 16 of the card's 132 SMs, and so about
// an eighth of its L2 bandwidth: a 3-D fine level's tap stage (65 weight
// planes, 6.3 MB at 29^3) is bound by the cluster's L2 bytes.

#include "gmg_cluster.cuh"

namespace {

constexpr int kModeCG = 0;
constexpr int kModeRichardson = 1;
// shared-memory slots of the CTA partials: <p, Ap>, <res, s>
constexpr int kPAp = 0, kRS = 1, kSlots = 2;

struct Hier {
  Level lv[kMaxLevels];
  Taps T[kMaxLevels];  // each level's taps in its windows
  float* p[2];         // CG search direction, fine level, double-buffered
  float* Ap;           // A0 p
  int nlev;
  int lstar;           // CTA 0 solves levels lstar.. in shared memory
  int reload;          // their W and D copied in at every coarse stage
};

// Level 0's post-smoothing stage after vcycle_to_fine_cl: s = V(res) into
// L0.t and this CTA's partial of <res, s> into red[kRS]
__device__ void smooth_dot(const Hier& H, float* sm, double* red, double* sh) {
  const Level& L0 = H.lv[0];
  const Band b = band(L0);
  const Window x = stage_smoothed(H.lv, H.T, 0, b, sm);
  const GlobalW w{L0.W, sites(L0)};
  double acc = 0.0;
  for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
    const float v = smooth_win(L0, H.T[0], w, x.s + x.site(L0, idx), idx);
    L0.t[idx] = v;
    acc += (double)ldw(L0.r + idx) * (double)v;
  }
  put_red(acc, red, kRS, sh);
}

__global__ void __launch_bounds__(kClusterThreads, 1)
gmg_fused_cg_kernel(const Hier* __restrict__ desc, const float* r_in,
                    float* z, int iters, int mode) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Hier H;
  __shared__ double sh[33];
  __shared__ double red[kSlots];
  __shared__ double bc[kSlots];
  {
    const int* src = reinterpret_cast<const int*>(desc);
    int* dst = reinterpret_cast<int*>(&H);
    for (int i = threadIdx.x; i < (int)(sizeof(Hier) / sizeof(int));
         i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();

  const Level& L0 = H.lv[0];
  const int n0 = sites(L0);
  const Band b0 = band(L0);
  float* keep = H.reload ? nullptr : cluster_smem;  // CTA 0: W, D of levels lstar..
  float* sm = cluster_smem + cta_kept_floats(H.lv, H.lstar, H.nlev, H.reload);  // windows, coarse work
  if (blockIdx.x == 0 && keep) cta_load(H.lv, H.lstar, H.nlev, keep);

  for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
    const float rv = r_in[idx];
    L0.r[idx] = rv;
    L0.x[idx] = __ldg(L0.D + idx) * rv;
    if (mode == kModeCG) z[idx] = 0.f;
  }
  cluster.sync();

  if (mode == kModeRichardson) {
    // z = V(r); then iters - 1 times z += V(r - A0 z)
    chain_to_last_cl(H.lv, H.T, H.nlev, H.lstar, r_in, z, iters, keep, sm, cluster);
    const Window x = stage_smoothed(H.lv, H.T, 0, b0, sm);
    const GlobalW w{L0.W, n0};
    for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x)
      z[idx] = chain_result_win(L0, H.T[0], w, x.s + x.site(L0, idx), z, idx, iters);
    return;  // no CTA reads another's shared memory in this mode
  }

  // s = V(r), rz = <r, s>; p = s is built by the first step's window
  vcycle_to_fine_cl(H.lv, H.T, H.nlev, H.lstar, keep, sm, cluster);
  smooth_dot(H, sm, red, sh);
  cluster.sync();
  double rz = cluster_total(cluster, red, bc, kRS);
  float beta = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float* p_old = H.p[it & 1];
    float* p = H.p[(it + 1) & 1];
    {
      // p = s + beta p_old over this CTA's window; Ap = A0 p and <p, Ap>
      // at its sites, p there into the other buffer
      const Window pw = window_of(L0, H.T[0], b0, sm);
      copy_in(sm, pw.plane, [&](int q) {
        const int row = q / pw.Lx, x = q - row * pw.Lx - pw.px;
        const int pl = row / pw.Ly;
        const int zz = pw.za + pl, y = pw.ya + row - pl * pw.Ly;
        if (zz < 0 || zz >= L0.nz || y < 0 || y >= L0.ny || x < 0 || x >= L0.nx) return 0.f;
        const int s = (zz * L0.ny + y) * L0.nx + x;
        const float sv = ldw(L0.t + s);
        return it == 0 ? sv : __fadd_rn(sv, __fmul_rn(beta, ldw(p_old + s)));
      });
      __syncthreads();
      const GlobalW w{L0.W, n0};
      double acc = 0.0;
      for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
        const float* u = pw.s + pw.site(L0, idx);
        const float ap = taps_at(L0, H.T[0].woff, w, u, idx);
        p[idx] = u[0];
        H.Ap[idx] = ap;
        acc += (double)u[0] * (double)ap;
      }
      put_red(acc, red, kPAp, sh);
    }
    cluster.sync();
    const double denom = cluster_total(cluster, red, bc, kPAp);
    const float alpha = (float)(rz / (fabs(denom) > 0.0 ? denom : 1.0));
    // z += alpha p;  res -= alpha Ap;  x = D0 res (each thread its own sites)
    for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
      z[idx] = __fadd_rn(z[idx], __fmul_rn(alpha, p[idx]));
      const float rv = __fsub_rn(L0.r[idx], __fmul_rn(alpha, H.Ap[idx]));
      L0.r[idx] = rv;
      L0.x[idx] = __ldg(L0.D + idx) * rv;
    }
    if (it == iters - 1) break;
    cluster.sync();
    vcycle_to_fine_cl(H.lv, H.T, H.nlev, H.lstar, keep, sm, cluster);
    smooth_dot(H, sm, red, sh);
    cluster.sync();
    const double rz_new = cluster_total(cluster, red, bc, kRS);
    beta = (float)(rz_new / (fabs(rz) > 0.0 ? rz : 1.0));
    rz = rz_new;
  }
  // keeps every CTA's shared memory alive until the last cluster_total
  // has read it
  cluster.sync();
}

// Dynamic shared memory of a CTA over a cluster of P, CTA 0 solving
// levels lstar..: the coarse levels' W and D (unless reloaded), then the
// larger of its windows and the coarse levels' work area.
int smem_bytes(const Hier& H, int lstar, bool reload, int P) {
  int area = window_floats(H.lv, H.T, lstar, 1, P);
  const int work = cta_shared_floats(H.lv, H.T, lstar, H.nlev, reload);
  area = work > area ? work : area;
  return (int)sizeof(float) * (cta_kept_floats(H.lv, lstar, H.nlev, reload) + area);
}

}  // namespace

extern "C" {

int gmg_fused_cg_desc_bytes() { return (int)sizeof(Hier); }

// Fill a host buffer of gmg_fused_cg_desc_bytes() bytes with the level
// descriptors (ptrs, dims, offs as pack_levels takes them), the CG work
// vectors (two p buffers and Ap, level-0 size) and the most levels CTA 0
// may solve in shared memory (0: cta_first_level's; 1: the coarsest
// alone).
int gmg_fused_cg_pack(void* out, int nlev, const long long* ptrs,
                      const int* dims, const int* offs, long long p0,
                      long long p1, long long Ap, int cta_levels) {
  Hier* H = static_cast<Hier*>(out);
  *H = Hier{};
  const int e = pack_levels(H->lv, nlev, ptrs, dims, offs);
  if (e != 0) return e;
  if (cta_levels < 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < nlev; ++l) window_taps(H->lv[l], H->T[l]);
  H->p[0] = reinterpret_cast<float*>(p0);
  H->p[1] = reinterpret_cast<float*>(p1);
  H->Ap = reinterpret_cast<float*>(Ap);
  H->nlev = nlev;
  H->lstar = cta_levels > 0 ? nlev - cta_levels : cta_first_level(H->lv, nlev);
  return 0;
}

// The cluster size and dynamic shared memory of a packed descriptor
// (host copy) on the current device, after choosing its l* (written into
// the descriptor); an error if no cluster of 8 or 16 CTAs with that memory
// can be resident.
int gmg_fused_cg_config(void* desc, int* cluster, int* smem) {
  Hier& H = *static_cast<Hier*>(desc);
  const int e = choose_lstar(gmg_fused_cg_kernel, H.nlev,
                             [&](int l, bool re, int P) { return smem_bytes(H, l, re, P); },
                             &H.lstar, &H.reload);
  if (e != 0) return e;
  return cluster_config(gmg_fused_cg_kernel,
                        [&](int P) { return smem_bytes(H, H.lstar, H.reload, P); }, cluster, smem);
}

// l* of a descriptor gmg_fused_cg_config has seen
int gmg_fused_cg_lstar(const void* desc) { return static_cast<const Hier*>(desc)->lstar; }

// One inner solve on r: mode 0 (cg) runs `iters` GMG-PCG steps, mode 1
// (richardson) a chain of `iters` V-cycles. desc: the packed descriptor in
// device memory; cluster and smem from gmg_fused_cg_config.
int gmg_fused_cg_launch(const void* desc, const float* r, float* z,
                        int iters, int mode, int cluster, int smem, void* stream) {
  if (mode != kModeCG && mode != kModeRichardson)
    return (int)cudaErrorInvalidValue;
  if (iters < (mode == kModeRichardson ? 1 : 0)) return (int)cudaErrorInvalidValue;
  return cluster_launch(gmg_fused_cg_kernel, cluster, smem, stream,
                        static_cast<const Hier*>(desc), r, z, iters, mode);
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
