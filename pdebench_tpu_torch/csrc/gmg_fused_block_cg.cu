// Whole block (d = 2) GMG-preconditioned inner solve in one launch of one
// thread-block cluster, for Hopper (sm_90a): the elasticity analog of
// gmg_fused_cg.cu.
//
// Replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_block_inner_cg` (pl.pallas_call at :723; kernel body
// `_kernel`, :620-700), 2-D block lattices with two components per site.
// Two modes, one kernel, as in gmg_fused_cg.cu:
//
// mode 0, cg: `iters` PCG steps on a block lattice residual r, writing the
// correction z (the recurrence of gmg_fused_cg.cu, every dot product
// summed over both components);
// mode 1, richardson: z = V(r), then iters - 1 times z += V(r - A0 z)
// (:671-679).
//
// Layout: a block level holds W (K, 2, 2, ny, nx), W[k, a, b] the plane
// that multiplies component b into component a, D (2, 2, ny, nx) omega
// times the point-block inverse diagonal, and planar work vectors (2, ny,
// nx) (gmg_block_vcycle.cuh). V is the block V-cycle on them; its
// coarsest level is the probed one below the GMG's last. r and z are the
// lattice's site-major (ny, nx, 2) vectors, read and written inside the
// first and last stages, so a call makes no layout copies.
//
// What bounds it: latency of dependent stages and the fine level's weight
// reads. The hierarchy is 5.2 MB (linear_elasticity_nu010, 121 x 121
// nodes, 19 block taps: 76 weight planes, 4.45 MB of them on level 0) to
// 9.2 MB (nu030, 161 x 161; 7.9 MB on level 0): it stays in the 50 MB L2,
// but every stage needs the whole previous one, and each PCG step reads
// level 0's weights three times (A0 p, the V-cycle's residual and its
// post-smoothing). The cooperative design this replaced (58-102 blocks of
// 256 threads, a grid barrier between 16-20 stages a step, the coarsest
// level swept by one block from L2, 32 us a V-cycle) took 2.68 / 3.22 ms
// a call on an H100 80GB HBM3 at 700 W (PERF.md §6). So, on
// gmg_cluster.cuh's stages:
// - one cluster of up to 16 CTAs x 1,024 threads is the whole launch, its
//   stages separated by the hardware cluster barrier; each CTA owns a band
//   of rows of every level and reads a tap stage's input from a
//   zero-padded window in shared memory (two component boxes);
// - level 0's weights are read through the read-only path (__ldg). Rows
//   of them held in shared memory for the launch measured slower, as did
//   rings that streamed them tap by tap (16-byte cp.async copies; bulk
//   copies on mbarriers) (PERF.md §6);
// - CTA 0 solves the levels from l* down in its shared memory, their W and
//   D copied in once per launch (cta2_load, cta2_vcycle: the block form of
//   gmg_cluster.cuh's cta_load / cta_vcycle): by default every level that
//   fits beside the windows (choose_lstar: nu010's 16^2, nu030's 21^2 and
//   11^2), whose coarsest 10 block-Jacobi sweeps the cooperative design
//   ran from L2;
// - level 0's residual stage computes x0 = D0 r on its window from the
//   stage before's vectors (the CG update r - alpha Ap, or the call's r),
//   so the update of r is not a stage of its own; the restriction into a
//   level is computed on the window of that level's residual stage and
//   the prolongation on the window of the post-smoothing stage; p = s +
//   beta p is built on the window of A0 p's stage. p and level 0's r are
//   double-buffered, so no CTA overwrites a value a neighbour still reads;
// - the PCG dots are CTA partials summed in double across the cluster in a
//   fixed order (cluster_total): deterministic, no atomics.
// Cluster barriers per PCG step: 2 l* + 2 (A0 p with <p, Ap>; z, r and
// level 0's residual; 2 (l* - 1) for levels 1..l*-1; the coarse stage;
// level 0's post-smoothing with <r, s>): 8 on nu010's and nu030's
// hierarchies (l* = 3), against the cooperative design's 16 and 20.
// Rounding: every per-site sum rounds as the plain version
// (FusedBlockInnerCG.plain) does, products and then sums, no fused
// multiply-add (taps2_rn, diag2_rn), in the same order wherever a level
// runs: CTA 0's levels equal, bit for bit, the same levels run as cluster
// stages.

#include "gmg_cluster.cuh"

namespace {

constexpr int kModeCG = 0;
constexpr int kModeRichardson = 1;
// block taps whose weight loads a site issues together: from L2 (kBatch2,
// gmg_cluster.cuh), from shared memory
constexpr int kBatchL2 = kBatch2;
constexpr int kBatchSmem = 2;
// shared-memory slots of the CTA partials: <p, Ap>, <r, s>
constexpr int kPAp = 0, kRS = 1, kSlots = 2;

struct BlockHier {
  Level lv[kMaxLevels];  // block levels; lv[0].r is rb[0]
  Taps T[kMaxLevels];    // each level's taps in its windows
  float* p[2];           // CG search direction (2, ny, nx), double-buffered
  float* Ap;             // A0 p
  float* rb[2];          // level 0's right-hand side, double-buffered
  float* zp;             // the Richardson chain's running sum (2, ny, nx)
  int nlev;
  int lstar;             // CTA 0 solves levels lstar.. in shared memory
  int reload;            // their W and D copied in at every coarse stage
  int area;              // floats of the windows / CTA 0's coarse work
};

// The launch's descriptor, copied in by every CTA. At namespace scope, so
// that the functions that are not inlined (cta2_vcycle, vcycle2_from_1)
// address it, and the dynamic shared memory, as shared memory.
__shared__ BlockHier hier;

// ---- per-site block sums, rounded as the plain version -------------------

// (y0, y1) = D (v0, v1) at site idx, d(2 a + b, idx) = D[a, b]
template <class DS>
__device__ __forceinline__ void diag2_rn(DS d, int idx, float v0, float v1, float& y0, float& y1) {
  y0 = __fadd_rn(__fmul_rn(d(0, idx), v0), __fmul_rn(d(1, idx), v1));
  y1 = __fadd_rn(__fmul_rn(d(2, idx), v0), __fmul_rn(d(3, idx), v1));
}

// (A u) at site idx of both components, u0 and u1 the site's places in the
// two component windows: taps in order, per tap the (a <- 0) and (a <- 1)
// products rounded and summed, then added (the plain version's _apply);
// kB taps' weight loads issued together
template <int kB, class WS>
__device__ __forceinline__ void taps2_rn(const Level& L, const int* woff, WS w, const float* u0,
                                         const float* u1, int idx, float& o0, float& o1) {
  float a0 = 0.f, a1 = 0.f;
  for (int k = 0; k < L.K; k += kB) {
    float w00[kB], w01[kB], w10[kB], w11[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const bool in = k + b < L.K;
      const int q = 4 * (k + b);
      w00[b] = in ? w(q, idx) : 0.f;      // W[k,0,0]
      w01[b] = in ? w(q + 1, idx) : 0.f;  // W[k,0,1]
      w10[b] = in ? w(q + 2, idx) : 0.f;  // W[k,1,0]
      w11[b] = in ? w(q + 3, idx) : 0.f;  // W[k,1,1]
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (k + b < L.K) {
        const float v0 = u0[woff[k + b]], v1 = u1[woff[k + b]];
        a0 = __fadd_rn(a0, __fadd_rn(__fmul_rn(w00[b], v0), __fmul_rn(w01[b], v1)));
        a1 = __fadd_rn(a1, __fadd_rn(__fmul_rn(w10[b], v0), __fmul_rn(w11[b], v1)));
      }
    }
  }
  o0 = a0;
  o1 = a1;
}

// post-smoothing value x + D (r - A x) at site idx, x0 and x1 its places
// in the component windows of x
template <int kB, class WS, class DS>
__device__ __forceinline__ void smooth2_rn(const Level& L, const int* woff, WS w, DS d,
                                           const float* x0, const float* x1, float r0, float r1,
                                           int idx, float& v0, float& v1) {
  float a0, a1, s0, s1;
  taps2_rn<kB>(L, woff, w, x0, x1, idx, a0, a1);
  diag2_rn(d, idx, __fsub_rn(r0, a0), __fsub_rn(r1, a1), s0, s1);
  v0 = __fadd_rn(x0[0], s0);
  v1 = __fadd_rn(x1[0], s1);
}

// The window of a block level vector computed site by site: v(idx, v0, v1)
// at the sites of 2-D level L the window of band b holds, zero outside the
// level, into two component boxes. Ends with a block barrier.
template <class V>
__device__ __forceinline__ Window stage_fn2(const Level& L, const Taps& T, Band b, float* s, V v) {
  const Window w = window_of(L, T, b, s);
  for (int q = threadIdx.x; q < w.plane; q += blockDim.x) {
    const int row = q / w.Lx, x = q - row * w.Lx - w.px;
    const int y = w.ya + row;
    float v0 = 0.f, v1 = 0.f;
    if (y >= 0 && y < L.ny && x >= 0 && x < L.nx) v(y * L.nx + x, v0, v1);
    s[q] = v0;
    s[w.plane + q] = v1;
  }
  __syncthreads();
  return w;
}

// A0 u at every site of this CTA's band b of level 0, u a stage's window
// (two component boxes), the weights read through the read-only path:
// done(idx, a0, a1) at each site
template <class Done>
__device__ __forceinline__ void fine_apply(const Level& L0, const Taps& T, Band b, const Window& u,
                                           Done done) {
  const int n = sites(L0);
  const float* u1 = u.s + u.plane;
  for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
    const int p = u.site(L0, idx);
    float a0, a1;
    taps2_rn<kBatchL2>(L0, T.woff, GlobalW{L0.W, n}, u.s + p, u1 + p, idx, a0, a1);
    done(idx, a0, a1);
  }
}

// ---- the coarse levels l*..L-1, one CTA -----------------------------------
//
// The block form of gmg_cluster.cuh's cta_load / cta_vcycle: CTA 0 holds
// W (4 K planes) and D (4 planes) of the levels from l* down in `keep`,
// copied in once per launch, and per level r (two planes) and two pairs
// of zero-padded component boxes x and y in `work`, which the coarse stage
// shares with the other stages' windows (keep null: W and D copied into
// the work area at every coarse stage). Every per-site sum is that of the
// cluster stages, so the coarse stage equals, bit for bit, the same levels
// run as cluster stages.

__host__ __device__ inline int cta2_keep_floats(const Level* lv, int lstar, int nlev) {
  int f = 0;
  for (int l = lstar; l < nlev; ++l) f += 4 * (lv[l].K + 1) * sites(lv[l]);
  return f;
}
__host__ __device__ inline int cta2_work_floats(const Level* lv, const Taps* T, int lstar, int nlev) {
  int f = 0;
  for (int l = lstar; l < nlev; ++l) f += 2 * sites(lv[l]) + 4 * box_floats(lv[l], T[l]);
  return f;
}

// Level l's arrays in CTA 0's shared memory; a box pair is component 0
// at x, component 1 at x + B
struct Cta2Level {
  const float* W;
  const float* D;
  float* r;
  float* x;
  float* y;
  int B;
};

__device__ __forceinline__ Cta2Level cta2_level(const Level* lv, const Taps* T, int lstar, int l,
                                                const float* keep, float* work) {
  keep += cta2_keep_floats(lv, lstar, l);
  work += cta2_work_floats(lv, T, lstar, l);
  const int n = sites(lv[l]), B = box_floats(lv[l], T[l]);
  return {keep, keep + 4 * lv[l].K * n, work, work + 2 * n, work + 2 * n + 2 * B, B};
}

// By CTA 0: W and D of levels lstar.. into keep
__device__ void cta2_load(const Level* lv, int lstar, int nlev, float* keep) {
  for (int l = lstar; l < nlev; ++l) {
    const Level& L = lv[l];
    const int n = sites(L);
    copy_in(keep, 4 * L.K * n, [&](int q) { return __ldg(L.W + q); });
    copy_in(keep + 4 * L.K * n, 4 * n, [&](int q) { return __ldg(L.D + q); });
    keep += 4 * (L.K + 1) * n;
  }
}

// By CTA 0: one block V-cycle of the descriptor's levels lstar..nlev-1
// (lstar >= 1), its right-hand side the restriction of lv[lstar - 1].t,
// its result into lv[lstar].t. The coarsest level takes x = D r and
// kCoarseSweeps - 1 block-Jacobi sweeps x += D (r - A x). W and D kept
// after the window area (unless reloaded), the work area at its start.
__device__ __noinline__ void cta2_vcycle() {
  const Level* lv = hier.lv;
  const Taps* T = hier.T;
  const int lstar = hier.lstar, nlev = hier.nlev;
  const float* keep = hier.reload ? nullptr : cluster_smem + hier.area;
  float* work = cluster_smem;
  if (keep == nullptr) {
    cta2_load(lv, lstar, nlev, work);
    keep = work;
    work += cta2_keep_floats(lv, lstar, nlev);
  }
  {
    // the boxes are read at their zero pads
    const int f = cta2_work_floats(lv, T, lstar, nlev);
    for (int q = threadIdx.x; q < f; q += blockDim.x) work[q] = 0.f;
  }
  __syncthreads();
  {
    const Level& F = lv[lstar - 1];
    const Level& C = lv[lstar];
    const int nf = sites(F), nc = sites(C);
    const Cta2Level c = cta2_level(lv, T, lstar, lstar, keep, work);
    for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) {
      const float r0 = restrict_cl(F, C, F.t, idx), r1 = restrict_cl(F, C, F.t + nf, idx);
      c.r[idx] = r0;
      c.r[nc + idx] = r1;
      const int p = box_site(C, T[lstar], idx);
      diag2_rn(SharedW{c.D, nc}, idx, r0, r1, c.x[p], c.x[c.B + p]);
    }
  }
  __syncthreads();
  for (int l = lstar; l < nlev - 1; ++l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = sites(F), nc = sites(C);
    const Cta2Level f = cta2_level(lv, T, lstar, l, keep, work);
    const Cta2Level c = cta2_level(lv, T, lstar, l + 1, keep, work);
    for (int idx = threadIdx.x; idx < nf; idx += blockDim.x) {
      const int p = box_site(F, T[l], idx);
      float a0, a1;
      taps2_rn<kBatchSmem>(F, T[l].woff, SharedW{f.W, nf}, f.x + p, f.x + f.B + p, idx, a0, a1);
      f.y[p] = __fsub_rn(f.r[idx], a0);
      f.y[f.B + p] = __fsub_rn(f.r[nf + idx], a1);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) {
      const float r0 = restrict_ld(F, C, box_ld(F, T[l], f.y), idx);
      const float r1 = restrict_ld(F, C, box_ld(F, T[l], f.y + f.B), idx);
      c.r[idx] = r0;
      c.r[nc + idx] = r1;
      const int p = box_site(C, T[l + 1], idx);
      diag2_rn(SharedW{c.D, nc}, idx, r0, r1, c.x[p], c.x[c.B + p]);
    }
    __syncthreads();
  }
  const float* res;  // the V-cycle's result (a box pair) at the level last finished
  {
    const Level& C = lv[nlev - 1];
    const Taps& TC = T[nlev - 1];
    const int n = sites(C);
    const Cta2Level c = cta2_level(lv, T, lstar, nlev - 1, keep, work);
    float* src = c.x;
    float* dst = c.y;
    for (int s = 0; s < kCoarseSweeps - 1; ++s) {
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        const int p = box_site(C, TC, idx);
        smooth2_rn<kBatchSmem>(C, TC.woff, SharedW{c.W, n}, SharedW{c.D, n}, src + p, src + c.B + p,
                               c.r[idx], c.r[n + idx], idx, dst[p], dst[c.B + p]);
      }
      __syncthreads();
      float* tmp = src; src = dst; dst = tmp;
    }
    res = src;
  }
  for (int l = nlev - 2; l >= lstar; --l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = sites(F), Bc = box_floats(C, T[l + 1]);
    const Cta2Level f = cta2_level(lv, T, lstar, l, keep, work);
    for (int idx = threadIdx.x; idx < nf; idx += blockDim.x) {
      const int p = box_site(F, T[l], idx);
      f.x[p] = __fadd_rn(f.x[p], prolong_ld(F, C, box_ld(C, T[l + 1], res), idx));
      f.x[f.B + p] = __fadd_rn(f.x[f.B + p], prolong_ld(F, C, box_ld(C, T[l + 1], res + Bc), idx));
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nf; idx += blockDim.x) {
      const int p = box_site(F, T[l], idx);
      smooth2_rn<kBatchSmem>(F, T[l].woff, SharedW{f.W, nf}, SharedW{f.D, nf}, f.x + p, f.x + f.B + p, f.r[idx],
                 f.r[nf + idx], idx, f.y[p], f.y[f.B + p]);
    }
    __syncthreads();
    res = f.y;
  }
  const Level& C = lv[lstar];
  const int n = sites(C), B = box_floats(C, T[lstar]);
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int p = box_site(C, T[lstar], idx);
    C.t[idx] = res[p];
    C.t[n + idx] = res[B + p];
  }
}

// ---- the V-cycle on the cluster -------------------------------------------

// Level 0's residual stage of a V-cycle on the right-hand side v (v(idx,
// v0, v1) at any site of level 0, from vectors no CTA writes in this
// stage): x0 = D0 v on the window of this CTA's band, and at its sites v
// into r_out (unless null), x0 into lv[0].x and t0 = v - A0 x0 into
// lv[0].t. The caller ends the stage with a cluster barrier.
template <class V>
__device__ __forceinline__ void fine_residual(const BlockHier& H, Band b, float* sm,
                                              float* r_out, V v) {
  const Level& L0 = H.lv[0];
  const int n = sites(L0);
  const Window x = stage_fn2(L0, H.T[0], b, sm, [&](int idx, float& x0, float& x1) {
    float v0, v1;
    v(idx, v0, v1);
    diag2_rn(GlobalW{L0.D, n}, idx, v0, v1, x0, x1);
    if (idx >= b.lo && idx < b.hi) {
      if (r_out) {
        r_out[idx] = v0;
        r_out[n + idx] = v1;
      }
      L0.x[idx] = x0;
      L0.x[n + idx] = x1;
    }
  });
  fine_apply(L0, H.T[0], b, x, [&](int idx, float a0, float a1) {
    float v0, v1;
    v(idx, v0, v1);
    L0.t[idx] = __fsub_rn(v0, a0);
    L0.t[n + idx] = __fsub_rn(v1, a1);
  });
}

// The V-cycle's stages from level 1 on, after level 0's residual stage and
// its cluster barrier: levels 1..lstar-1 as cluster stages (the
// restriction into a level computed on the window of its residual stage),
// levels lstar.. by CTA 0 (cta2_vcycle), then the post-smoothing of levels
// lstar-1..1 (the prolongation computed on its window). Afterwards
// fine_smooth gives the V-cycle's result. Ends with a cluster barrier.
__device__ void vcycle2_from_1(cg::cluster_group& cluster) {
  const BlockHier& H = hier;
  float* sm = cluster_smem;
  for (int l = 1; l < H.lstar; ++l) {
    const Level& F = H.lv[l - 1];
    const Level& C = H.lv[l];
    const int nf = sites(F), nc = sites(C);
    const Band b = band(C);
    const Window x = stage_fn2(C, H.T[l], b, sm, [&](int idx, float& x0, float& x1) {
      const float r0 = restrict_cl(F, C, F.t, idx), r1 = restrict_cl(F, C, F.t + nf, idx);
      diag2_rn(GlobalW{C.D, nc}, idx, r0, r1, x0, x1);
      if (idx >= b.lo && idx < b.hi) {
        C.r[idx] = r0;
        C.r[nc + idx] = r1;
        C.x[idx] = x0;
        C.x[nc + idx] = x1;
      }
    });
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
      const int p = x.site(C, idx);
      float a0, a1;
      taps2_rn<kBatchL2>(C, H.T[l].woff, GlobalW{C.W, nc}, x.s + p, x.s + x.plane + p, idx, a0, a1);
      C.t[idx] = __fsub_rn(ldw(C.r + idx), a0);
      C.t[nc + idx] = __fsub_rn(ldw(C.r + nc + idx), a1);
    }
    cluster.sync();
  }
  if (blockIdx.x == 0) cta2_vcycle();
  cluster.sync();
  for (int l = H.lstar - 1; l >= 1; --l) {
    const Level& F = H.lv[l];
    const Level& C = H.lv[l + 1];
    const int nf = sites(F), nc = sites(C);
    const Band b = band(F);
    const Window x = stage_fn2(F, H.T[l], b, sm, [&](int idx, float& x0, float& x1) {
      x0 = __fadd_rn(ldw(F.x + idx), prolong_cl(F, C, C.t, idx));
      x1 = __fadd_rn(ldw(F.x + nf + idx), prolong_cl(F, C, C.t + nc, idx));
    });
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
      const int p = x.site(F, idx);
      float v0, v1;
      smooth2_rn<kBatchL2>(F, H.T[l].woff, GlobalW{F.W, nf}, GlobalW{F.D, nf}, x.s + p, x.s + x.plane + p,
                 ldw(F.r + idx), ldw(F.r + nf + idx), idx, v0, v1);
      F.t[idx] = v0;
      F.t[nf + idx] = v1;
    }
    cluster.sync();
  }
}

// Level 0's post-smoothing, the V-cycle's last stage: s = x + D0 (r - A0 x)
// with x = lv[0].x + P lv[1].t computed on the window, r the V-cycle's
// right-hand side (two planes); done(idx, s0, s1) at this CTA's sites.
template <class Done>
__device__ __forceinline__ void fine_smooth(const BlockHier& H, Band b, float* sm,
                                            const float* r, Done done) {
  const Level& L0 = H.lv[0];
  const Level& L1 = H.lv[1];
  const int n = sites(L0), n1 = sites(L1);
  const Window x = stage_fn2(L0, H.T[0], b, sm, [&](int idx, float& x0, float& x1) {
    x0 = __fadd_rn(ldw(L0.x + idx), prolong_cl(L0, L1, L1.t, idx));
    x1 = __fadd_rn(ldw(L0.x + n + idx), prolong_cl(L0, L1, L1.t + n1, idx));
  });
  fine_apply(L0, H.T[0], b, x, [&](int idx, float a0, float a1) {
    const int p = x.site(L0, idx);
    float s0, s1;
    diag2_rn(GlobalW{L0.D, n}, idx, __fsub_rn(ldw(r + idx), a0), __fsub_rn(ldw(r + n + idx), a1),
             s0, s1);
    done(idx, __fadd_rn(x.s[p], s0), __fadd_rn(x.s[x.plane + p], s1));
  });
}

__global__ void __launch_bounds__(kClusterThreads, 1)
gmg_fused_block_cg_kernel(const BlockHier* __restrict__ desc, const float* __restrict__ r_in,
                          float* z, int iters, int mode) {
  cg::cluster_group cluster = cg::this_cluster();
  BlockHier& H = hier;
  __shared__ double sh[33];
  __shared__ double red[kSlots];
  __shared__ double bc[kSlots];
  {
    const int* src = reinterpret_cast<const int*>(desc);
    int* dst = reinterpret_cast<int*>(&H);
    for (int i = threadIdx.x; i < (int)(sizeof(BlockHier) / sizeof(int)); i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();

  const Level& L0 = H.lv[0];
  const int n0 = sites(L0);
  const Band b0 = band(L0);
  // dynamic shared memory: windows and CTA 0's coarse work, then CTA 0's
  // kept coarse W and D
  float* sm = cluster_smem;
  if (blockIdx.x == 0 && !H.reload) {
    cta2_load(H.lv, H.lstar, H.nlev, cluster_smem + H.area);
    __syncthreads();
  }

  // the call's r, site-major
  const auto r_call = [&](int idx, float& v0, float& v1) {
    v0 = r_in[2 * idx];
    v1 = r_in[2 * idx + 1];
  };

  if (mode == kModeRichardson) {
    // z = V(r); then iters - 1 times z += V(r - A0 z), the running sum in zp
    float* v = H.rb[0];  // a cycle's right-hand side
    float* zp = H.zp;
    for (int c = 0; c < iters; ++c) {
      if (c == 0) {
        fine_residual(H, b0, sm, v, r_call);
      } else {
        // v = r - A0 zp at this CTA's sites
        const Window zw = stage_in(zp, L0, H.T[0], b0, 2, sm);
        fine_apply(L0, H.T[0], b0, zw, [&](int idx, float a0, float a1) {
          v[idx] = __fsub_rn(r_in[2 * idx], a0);
          v[n0 + idx] = __fsub_rn(r_in[2 * idx + 1], a1);
        });
        cluster.sync();
        fine_residual(H, b0, sm, nullptr, [&](int idx, float& v0, float& v1) {
          v0 = ldw(v + idx);
          v1 = ldw(v + n0 + idx);
        });
      }
      cluster.sync();
      vcycle2_from_1(cluster);
      const bool last = c == iters - 1;
      fine_smooth(H, b0, sm, v, [&](int idx, float s0, float s1) {
        const float y0 = c == 0 ? s0 : __fadd_rn(ldw(zp + idx), s0);
        const float y1 = c == 0 ? s1 : __fadd_rn(ldw(zp + n0 + idx), s1);
        if (last) {
          z[2 * idx] = y0;
          z[2 * idx + 1] = y1;
        } else {
          zp[idx] = y0;
          zp[n0 + idx] = y1;
        }
      });
      if (!last) cluster.sync();
    }
    return;  // no CTA reads another's shared memory in this mode
  }

  // s = V(r), rz = <r, s>; p = s is built by the first step's window
  double acc = 0.0;
  const auto smooth_dot = [&](const float* r) {
    acc = 0.0;
    fine_smooth(H, b0, sm, r, [&](int idx, float s0, float s1) {
      L0.t[idx] = s0;
      L0.t[n0 + idx] = s1;
      acc += (double)ldw(r + idx) * (double)s0 + (double)ldw(r + n0 + idx) * (double)s1;
    });
    put_red(acc, red, kRS, sh);
  };
  for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
    z[2 * idx] = 0.f;
    z[2 * idx + 1] = 0.f;
  }
  fine_residual(H, b0, sm, H.rb[0], r_call);
  cluster.sync();
  vcycle2_from_1(cluster);
  smooth_dot(H.rb[0]);
  cluster.sync();
  double rz = cluster_total(cluster, red, bc, kRS);
  float beta = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float* p_old = H.p[it & 1];
    float* p = H.p[(it + 1) & 1];
    const float* r_old = H.rb[it & 1];
    float* r_new = H.rb[(it + 1) & 1];
    {
      // p = s + beta p_old over this CTA's window; Ap = A0 p and <p, Ap>
      // at its sites, p there into the other buffer
      const Window pw = stage_fn2(L0, H.T[0], b0, sm, [&](int idx, float& v0, float& v1) {
        const float s0 = ldw(L0.t + idx), s1 = ldw(L0.t + n0 + idx);
        v0 = it == 0 ? s0 : __fadd_rn(s0, __fmul_rn(beta, ldw(p_old + idx)));
        v1 = it == 0 ? s1 : __fadd_rn(s1, __fmul_rn(beta, ldw(p_old + n0 + idx)));
      });
      acc = 0.0;
      fine_apply(L0, H.T[0], b0, pw, [&](int idx, float a0, float a1) {
        const int q = pw.site(L0, idx);
        const float u0 = pw.s[q], u1 = pw.s[pw.plane + q];
        p[idx] = u0;
        p[n0 + idx] = u1;
        H.Ap[idx] = a0;
        H.Ap[n0 + idx] = a1;
        acc += (double)u0 * (double)a0 + (double)u1 * (double)a1;
      });
      put_red(acc, red, kPAp, sh);
    }
    cluster.sync();
    const double denom = cluster_total(cluster, red, bc, kPAp);
    const float alpha = (float)(rz / (fabs(denom) > 0.0 ? denom : 1.0));
    // z += alpha p (each thread its own sites)
    for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
      z[2 * idx] = __fadd_rn(z[2 * idx], __fmul_rn(alpha, ldw(p + idx)));
      z[2 * idx + 1] = __fadd_rn(z[2 * idx + 1], __fmul_rn(alpha, ldw(p + n0 + idx)));
    }
    if (it == iters - 1) break;
    // r -= alpha Ap, into the other buffer, and level 0's residual stage
    fine_residual(H, b0, sm, r_new, [&](int idx, float& v0, float& v1) {
      v0 = __fsub_rn(ldw(r_old + idx), __fmul_rn(alpha, ldw(H.Ap + idx)));
      v1 = __fsub_rn(ldw(r_old + n0 + idx), __fmul_rn(alpha, ldw(H.Ap + n0 + idx)));
    });
    cluster.sync();
    vcycle2_from_1(cluster);
    smooth_dot(r_new);
    cluster.sync();
    const double rz_new = cluster_total(cluster, red, bc, kRS);
    beta = (float)(rz_new / (fabs(rz) > 0.0 ? rz : 1.0));
    rz = rz_new;
  }
  // keeps every CTA's shared memory alive until the last cluster_total
  // has read it
  cluster.sync();
}

// ---- host side ------------------------------------------------------------

int align4(int f) { return (f + 3) / 4 * 4; }

// Floats of the windows / coarse work area over a cluster of P, CTA 0
// solving levels lstar..: the larger of the windows of the levels run as
// cluster stages (two components) and the coarse work area (with the
// coarse W and D on reload); a multiple of 4, as what follows it is
// 16-byte aligned.
int area_floats(const BlockHier& H, int lstar, bool reload, int P) {
  const int win = window_floats(H.lv, H.T, lstar, 2, P);
  const int work = cta2_work_floats(H.lv, H.T, lstar, H.nlev) +
                   (reload ? cta2_keep_floats(H.lv, lstar, H.nlev) : 0);
  return align4(work > win ? work : win);
}

// Dynamic shared memory of a CTA: the area above, then CTA 0's coarse W
// and D kept for the launch (none on reload).
int smem_bytes(const BlockHier& H, int lstar, bool reload, int P) {
  const int kept = reload ? 0 : cta2_keep_floats(H.lv, lstar, H.nlev);
  return (int)sizeof(float) * (area_floats(H, lstar, reload, P) + kept);
}

}  // namespace

extern "C" {

int gmg_fused_block_cg_desc_bytes() { return (int)sizeof(BlockHier); }

// Fill a host buffer of gmg_fused_block_cg_desc_bytes() bytes with the
// block level descriptors (ptrs, dims, offs as pack_levels takes them; W,
// D and the work vectors r, x, t in the block layout above), the CG work
// vectors (two p buffers, Ap and level 0's second right-hand side, each
// (2, ny, nx)), the chain's running sum zp, the most levels CTA 0 may
// solve in shared memory (0: as many as fit; 1: the coarsest alone).
int gmg_fused_block_cg_pack(void* out, int nlev, const long long* ptrs, const int* dims,
                            const int* offs, long long p0, long long p1, long long Ap, long long r1,
                            long long zp, int cta_levels) {
  BlockHier* H = static_cast<BlockHier*>(out);
  *H = BlockHier{};
  const int e = pack_levels(H->lv, nlev, ptrs, dims, offs);
  if (e != 0) return e;
  if (cta_levels < 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < nlev; ++l) {  // 2-D block levels only
    if (H->lv[l].nz != 1) return (int)cudaErrorInvalidValue;
    window_taps(H->lv[l], H->T[l]);
  }
  H->p[0] = reinterpret_cast<float*>(p0);
  H->p[1] = reinterpret_cast<float*>(p1);
  H->Ap = reinterpret_cast<float*>(Ap);
  H->rb[0] = H->lv[0].r;
  H->rb[1] = reinterpret_cast<float*>(r1);
  H->zp = reinterpret_cast<float*>(zp);
  H->nlev = nlev;
  // by default every coarse level that fits (choose_lstar), unlike the
  // scalar 2-D kernels: CTA 0 on nu030's 21^2 and 11^2 measured 2% faster
  // than on 11^2 alone (PERF.md §6)
  H->lstar = cta_levels > 0 ? nlev - cta_levels : 1;
  return 0;
}

// The cluster size and dynamic shared memory of a packed descriptor (host
// copy) on the current device, after choosing its l* (written into the
// descriptor); an error if no cluster of 8 or 16 CTAs with that memory can
// be resident.
int gmg_fused_block_cg_config(void* desc, int* cluster, int* smem) {
  BlockHier& H = *static_cast<BlockHier*>(desc);
  int e = choose_lstar(gmg_fused_block_cg_kernel, H.nlev,
                       [&](int l, bool re, int P) { return smem_bytes(H, l, re, P); }, &H.lstar,
                       &H.reload);
  if (e != 0) return e;
  e = cluster_config(gmg_fused_block_cg_kernel,
                     [&](int P) { return smem_bytes(H, H.lstar, H.reload, P); }, cluster, smem);
  if (e != 0) return e;
  H.area = area_floats(H, H.lstar, H.reload, *cluster);
  return 0;
}

// l* of a descriptor gmg_fused_block_cg_config has seen
int gmg_fused_block_cg_lstar(const void* desc) { return static_cast<const BlockHier*>(desc)->lstar; }

// One inner solve on r (ny, nx, 2): mode 0 (cg) runs `iters` block
// GMG-PCG steps, mode 1 (richardson) a chain of `iters` block V-cycles;
// z (ny, nx, 2). desc: the packed descriptor in device memory; cluster and
// smem from gmg_fused_block_cg_config.
int gmg_fused_block_cg_launch(const void* desc, const float* r, float* z, int iters, int mode,
                              int cluster, int smem, void* stream) {
  if (mode != kModeCG && mode != kModeRichardson) return (int)cudaErrorInvalidValue;
  if (iters < (mode == kModeRichardson ? 1 : 0)) return (int)cudaErrorInvalidValue;
  return cluster_launch(gmg_fused_block_cg_kernel, cluster, smem, stream,
                        static_cast<const BlockHier*>(desc), r, z, iters, mode);
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
