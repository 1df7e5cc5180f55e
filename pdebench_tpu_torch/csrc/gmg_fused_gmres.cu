// One whole left-preconditioned Arnoldi cycle in one launch of one
// thread-block cluster, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_inner_gmres` (pl.pallas_call at :1269; kernel body
// `_kernel`, :1121-1245), 2-D and 3-D scalar lattices (the 3-D form: the
// slab-packed `_Level3` levels and operator, :1058-1065, :1289-1322), with
// the per-call operator input (`step_offsets`): the Arnoldi operator is
// the stencil W_op with its own taps, the preconditioner M is a chain of
// `cycles` V-cycles on the hierarchy (z = V(v); z += V(v - A0 z)), A0 the
// hierarchy's level 0. On
// a lattice residual r it writes the basis V (m+1 planes), the Arnoldi
// Hessenberg matrix column by column (Hc, m rows of m+1) and beta:
//
//   V = 0, Hc = 0
//   g0 = M r;  beta = ||g0||;  V[0] = g0 / max(beta, 1e-30);  alive = 1
//   for j < m:
//     u = alive * M (W_op * V[j]);  w = u
//     for i <= j:  h_ij = <V[i], w>;  w -= h_ij V[i]      (MGS)
//     hn = ||w||;  alive *= (hn > 1e-5 ||u||)             (happy breakdown)
//     H[j+1, j] = alive * hn;  V[j+1] = alive * w / max(hn, 1e-30)
//
// H holds the MGS coefficients the recurrence actually used, never a
// recomputed <V, M A V>: once float MGS loses orthogonality the two part,
// and only the former keeps the least squares reducing the residual. The
// caller solves the (m+1, m) least squares and forms z = sum_i y_i V[i].
// The frozen steps after a breakdown write exact zeros. Every row of V is
// written below before any step reads it (the Pallas kernel also zeroes V
// first; here only Hc is zeroed).
//
// What bounds it on this card: latency of dependent stages. One step is a
// stencil apply, two V-cycles and j + 1 Gram-Schmidt terms, each needing
// the whole result of the stage before: about 30 + j barriers per step on
// a 4-level hierarchy, some 1,300 per cycle at m = 30, while the hierarchy
// (~1 MB in 2-D, ~10 MB at 33^3) and the basis (31 planes, 3.2 MB at 161^2,
// 4.5 MB at 33^3) stay in the 50 MB L2. On an H100 80GB HBM3 at 700 W
// the cooperative design this replaced (one launch, grid barriers) spent
// 3-4 us per stage on 100-140 blocks, and its one-block coarsest sweep,
// from L2, 55 us (2-D) and 88 us (33^3) per V-cycle: a third to two
// fifths of the cycle (PERF.md, stage stamps).
// So this design (gmg_cluster.cuh):
// - one cluster of up to 16 CTAs x 1,024 threads is the whole launch, its
//   stages separated by the hardware cluster barrier (0.79 us empty at 16
//   CTAs against 1.1 us for a cooperative grid barrier, same card);
// - each CTA owns a band of rows of every level; a tap stage first copies
//   the zero-padded box of the input vector its band's taps reach into
//   shared memory, reads it without bounds checks, and issues each site's
//   weight loads kBatch at a time;
// - the coarse levels are solved by one CTA from shared memory: in 3-D
//   every level from l* down that fits, in 2-D the coarsest
//   (cta_first_level), their weights and D copied in once per launch; the
//   coarse stage restricts into level l* and runs those levels' V-cycle,
//   the coarsest level's 10 sweeps included, on block barriers;
// - w, the vector being orthogonalised, lives in shared memory at its
//   owner's sites across the j + 1 MGS terms (each thread owns fixed
//   sites); each axpy w -= h_i V[i] is fused with the CTA partial of the
//   next term's dot <V[i+1], w> (or of ||w||^2 after the last), one
//   cluster barrier per term, the partials double-buffered in shared-
//   memory slots and summed across the cluster through distributed shared
//   memory in a fixed order, in double: every CTA holds the same h, hn and
//   alive, deterministically and without atomics.
// The price: one cluster has 16 of the card's 132 SMs, and so about an
// eighth of its L2 bandwidth. In 3-D a fine tap stage reads 65 weight
// planes (9.3 MB at 33^3, 48 MB at 57^3), six such stages per Arnoldi
// step, so the 3-D fine stages are bound by the cluster's L2 bytes, and at
// 57^3 the hierarchy, W_op and the basis (23 MB) no longer fit in L2.

#include "gmg_cluster.cuh"

namespace {

constexpr float kEps = 1e-30f;
constexpr float kFreeze = 1e-5f;
// shared-memory slots of the CTA partials: two for MGS, ||w||^2, ||u||^2
constexpr int kMgs = 0, kW = 2, kU = 3, kSlots = 4;
constexpr int kMaxSteps = 128;  // m, Arnoldi steps per cycle

struct Hier {
  Level lv[kMaxLevels];
  Level op;            // Arnoldi operator: taps and shape; W per launch
  Taps T[kMaxLevels];  // each level's taps in its windows
  Taps Top;            // the operator's
  float* Av;  // W_op V[j], the preconditioner's input
  float* z1;  // the V-cycle chain's accumulator
  int nlev;
  int lstar;   // CTA 0 solves levels lstar.. in shared memory
  int reload;  // their W and D copied in at every coarse stage
};

__global__ void __launch_bounds__(kClusterThreads, 1)
gmg_fused_gmres_kernel(const Hier* __restrict__ desc, const float* r_in,
                       const float* Wop, float* V, float* Hc,
                       float* beta_out, int m, int cycles) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Hier H;
  __shared__ double sh[33];
  __shared__ double red[kSlots];
  __shared__ double bc[kSlots];
  // the step's Hessenberg column, written out with the step's last stage
  __shared__ float hcol[kMaxSteps + 1];
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
  float* w = cluster_smem;                         // w at this CTA's sites
  float* keep = H.reload ? nullptr : w + band_cap(L0, gridDim.x);  // CTA 0: W, D of levels lstar..
  float* sm = w + band_cap(L0, gridDim.x) +
              cta_kept_floats(H.lv, H.lstar, H.nlev, H.reload);  // windows, coarse work
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;

  if (blockIdx.x == 0 && keep) cta_load(H.lv, H.lstar, H.nlev, keep);

  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < m * (m + 1); q += blockDim.x) Hc[q] = 0.f;
  // the chain's input is r
  for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
    const float rv = r_in[idx];
    L0.r[idx] = rv;
    L0.x[idx] = __ldg(L0.D + idx) * rv;
  }
  cluster.sync();

  // g0 = M r;  beta = ||g0||;  V[0] = g0 / max(beta, eps)
  chain_to_last_cl(H.lv, H.T, H.nlev, H.lstar, r_in, H.z1, cycles, keep, sm, cluster);
  {
    const Window x = stage_smoothed(H.lv, H.T, 0, b0, sm);
    double acc = 0.0;
    const GlobalW wt{L0.W, n0};
    for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
      const float g = chain_result_win(L0, H.T[0], wt, x.s + x.site(L0, idx), H.z1, idx, cycles);
      w[idx - b0.lo] = g;
      acc += (double)g * (double)g;
    }
    put_red(acc, red, kW, sh);
  }
  cluster.sync();
  const float beta = (float)sqrt(cluster_total(cluster, red, bc, kW));
  if (leader) *beta_out = beta;
  for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x)
    V[idx] = w[idx - b0.lo] / fmaxf(beta, kEps);
  cluster.sync();

  float alive = 1.f;
  for (int j = 0; j < m; ++j) {
    const float* vj = V + (size_t)j * n0;
    // the preconditioner's input W_op V[j]
    {
      const Window v = stage_in(vj, H.op, H.Top, b0, 1, sm);
      const GlobalW wt{Wop, n0};
      for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
        const float a = taps_at(H.op, H.Top.woff, wt, v.s + v.site(H.op, idx), idx);
        H.Av[idx] = a;
        L0.r[idx] = a;
        L0.x[idx] = __ldg(L0.D + idx) * a;
      }
    }
    cluster.sync();
    chain_to_last_cl(H.lv, H.T, H.nlev, H.lstar, H.Av, H.z1, cycles, keep, sm, cluster);
    // u = alive * M Av;  w = u;  partials of <V[0], u> and ||u||^2
    {
      const Window x = stage_smoothed(H.lv, H.T, 0, b0, sm);
      double acc = 0.0, accu = 0.0;
      const GlobalW wt{L0.W, n0};
      for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
        const float u = alive * chain_result_win(L0, H.T[0], wt, x.s + x.site(L0, idx), H.z1,
                                                 idx, cycles);
        w[idx - b0.lo] = u;
        acc += (double)ldw(V + idx) * (double)u;
        accu += (double)u * (double)u;
      }
      put_red(acc, red, kMgs, sh);
      put_red(accu, red, kU, sh);
    }
    cluster.sync();
    // MGS, one stage per term: w -= h_i V[i] with the next term's partial
    for (int i = 0; i <= j; ++i) {
      const float h = (float)cluster_total(cluster, red, bc, kMgs + (i & 1));
      if (leader) hcol[i] = h;
      const float* vi = V + (size_t)i * n0;
      const float* vn = V + (size_t)(i + 1) * n0;
      double acc = 0.0;
      for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x) {
        const float wv = __fsub_rn(w[idx - b0.lo], __fmul_rn(h, ldw(vi + idx)));
        w[idx - b0.lo] = wv;
        acc += (i < j ? (double)ldw(vn + idx) : (double)wv) * (double)wv;
      }
      put_red(acc, red, i < j ? kMgs + ((i + 1) & 1) : kW, sh);
      cluster.sync();
    }
    const float hn = (float)sqrt(cluster_total(cluster, red, bc, kW));
    const float unorm = (float)sqrt(cluster_total(cluster, red, bc, kU));
    alive = hn > kFreeze * unorm ? alive : 0.f;
    if (leader) {
      hcol[j + 1] = alive * hn;
      for (int i = 0; i <= j + 1; ++i) Hc[(size_t)j * (m + 1) + i] = hcol[i];
    }
    float* vnext = V + (size_t)(j + 1) * n0;
    for (int idx = b0.lo + threadIdx.x; idx < b0.hi; idx += blockDim.x)
      vnext[idx] = alive * w[idx - b0.lo] / fmaxf(hn, kEps);
    // also keeps every CTA's shared memory alive until the last
    // cluster_total has read it
    cluster.sync();
  }
}

// Dynamic shared memory of a CTA over a cluster of P, CTA 0 solving
// levels lstar..: w at its sites of level 0, the coarse levels' W and D
// (unless reloaded), then the largest of its windows and the coarse
// levels' work area.
int smem_bytes(const Hier& H, int lstar, bool reload, int P) {
  int area = window_floats(H.lv, H.T, lstar, 1, P);
  const int op = window_floats(&H.op, &H.Top, 1, 1, P);
  const int coarse = cta_shared_floats(H.lv, H.T, lstar, H.nlev, reload);
  area = op > area ? op : area;
  area = coarse > area ? coarse : area;
  return (int)sizeof(float) *
         (band_cap(H.lv[0], P) + cta_kept_floats(H.lv, lstar, H.nlev, reload) + area);
}

}  // namespace

extern "C" {

int gmg_fused_gmres_desc_bytes() { return (int)sizeof(Hier); }

// Fill a host buffer of gmg_fused_gmres_desc_bytes() bytes: the levels
// (ptrs, dims, offs as pack_levels takes them), the operator's taps
// (op_K triples (dz, dy, dx) in op_offs; its shape is level 0's) and the
// work vectors Av and z1 (level-0 size).
int gmg_fused_gmres_pack(void* out, int nlev, const long long* ptrs,
                         const int* dims, const int* offs, int op_K,
                         const int* op_offs, long long Av, long long z1) {
  Hier* H = static_cast<Hier*>(out);
  *H = Hier{};
  int e = pack_levels(H->lv, nlev, ptrs, dims, offs);
  if (e != 0) return e;
  if (op_K < 1) return (int)cudaErrorInvalidValue;
  e = set_taps(H->op, op_K, op_offs);
  if (e != 0) return e;
  H->op.nz = H->lv[0].nz;
  H->op.ny = H->lv[0].ny;
  H->op.nx = H->lv[0].nx;
  for (int l = 0; l < nlev; ++l) window_taps(H->lv[l], H->T[l]);
  window_taps(H->op, H->Top);
  H->Av = reinterpret_cast<float*>(Av);
  H->z1 = reinterpret_cast<float*>(z1);
  H->nlev = nlev;
  H->lstar = cta_first_level(H->lv, nlev);
  return 0;
}

// The cluster size and dynamic shared memory of a packed descriptor
// (host copy) on the current device, after choosing its l* (written into
// the descriptor); an error if no cluster of 8 or 16 CTAs with that memory
// can be resident.
int gmg_fused_gmres_config(void* desc, int* cluster, int* smem) {
  Hier& H = *static_cast<Hier*>(desc);
  const int e = choose_lstar(gmg_fused_gmres_kernel, H.nlev,
                             [&](int l, bool re, int P) { return smem_bytes(H, l, re, P); },
                             &H.lstar, &H.reload);
  if (e != 0) return e;
  return cluster_config(gmg_fused_gmres_kernel,
                        [&](int P) { return smem_bytes(H, H.lstar, H.reload, P); }, cluster, smem);
}

// l* of a descriptor gmg_fused_gmres_config has seen
int gmg_fused_gmres_lstar(const void* desc) { return static_cast<const Hier*>(desc)->lstar; }

// One Arnoldi cycle of m steps on r with the operator Wop (op_K, nz, ny,
// nx): V (m+1, nz, ny, nx), Hc (m, m+1), beta (1 float) are written.
// desc: the packed descriptor in device memory; cluster and smem from
// gmg_fused_gmres_config.
int gmg_fused_gmres_launch(const void* desc, const float* r,
                           const float* Wop, float* V, float* Hc,
                           float* beta, int m, int cycles, int cluster,
                           int smem, void* stream) {
  if (m < 1 || m > kMaxSteps || cycles < 1) return (int)cudaErrorInvalidValue;
  return cluster_launch(gmg_fused_gmres_kernel, cluster, smem, stream,
                        static_cast<const Hier*>(desc), r, Wop, V, Hc, beta, m, cycles);
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
