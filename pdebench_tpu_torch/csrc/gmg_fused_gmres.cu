// One whole left-preconditioned Arnoldi cycle in one cooperative launch,
// for Hopper (sm_90a).
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
// The frozen steps after a breakdown write exact zeros. V is zeroed first,
// as the Pallas kernel does (every row is also written below: no step
// reads a row before it is written).
//
// What bounds it on this card: latency of dependent stages. One step is a
// stencil apply, two V-cycles and j + 1 Gram-Schmidt terms, each needing
// the whole result of the stage before: about 30 + j grid-wide barriers
// per step on a 4-level hierarchy, some 1,400 per cycle at m = 30, while
// the hierarchy (~1 MB) and the basis (31 x 161 x 161 x 4 B = 3.2 MB)
// stay in the 50 MB L2. The design keeps the Pallas kernel's shape, one
// launch per cycle with everything resident, and spends one barrier per
// Gram-Schmidt term: each axpy w -= h_i V[i] is fused with the block
// partial of the next term's dot <V[i+1], w> (or of ||w||^2 after the
// last), the partials double-buffered so that a stage never overwrites a
// buffer another block may still be summing. Dots reduce in double, one
// partial per block summed in a fixed order by every block, so every
// block holds the same h, hn and alive, deterministically and without
// atomics. Work vectors written in the kernel are read through L2
// (__ldcg).
//
// In 3-D (P2 tetrahedra, 33^3 to 57^3 sites) a stage is no longer short:
// the fine apply reads 65 weight planes (9.3 MB at 33^3, 48 MB at 57^3)
// and the operator W_op as many again, so the fine-level stages are bound
// by L2 / HBM bytes rather than by the barrier alone, and at 57^3 the
// hierarchy, W_op and the 31-plane basis (23 MB) do not fit in L2. The
// design is unchanged: the levels keep their (nz, ny, nx) layout and every
// stage walks the flat site index (coalesced), where the Pallas kernel
// flattens them into slab-packed planes for its 2-D rolls.

#include "gmg_vcycle.cuh"

namespace {

constexpr int kSlots = 4;  // partial buffers: two for MGS, ||w||^2, ||u||^2
constexpr float kEps = 1e-30f;
constexpr float kFreeze = 1e-5f;

struct Hier {
  Level lv[kMaxLevels];
  Level op;         // Arnoldi operator: taps and shape; W set per launch
  float* Av;        // W_op V[j], the preconditioner's input
  float* z1;        // the V-cycle chain's accumulator
  float* w;         // the vector being orthogonalised
  double* partial;  // kSlots * gridDim.x block partials
  int nlev;
};

__global__ void __launch_bounds__(kThreads)
gmg_fused_gmres_kernel(const Hier* __restrict__ desc, const float* r_in,
                       const float* Wop, float* V, float* Hc,
                       float* beta_out, int m, int cycles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Hier H;
  __shared__ double sh[33];
  {
    const int* src = reinterpret_cast<const int*>(desc);
    int* dst = reinterpret_cast<int*>(&H);
    for (int i = threadIdx.x; i < (int)(sizeof(Hier) / sizeof(int));
         i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) H.op.W = Wop;
  __syncthreads();

  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const Level& L0 = H.lv[0];
  const int n0 = sites(L0);
  const int G = gridDim.x;
  double* const pmgs[2] = {H.partial, H.partial + G};
  double* const pw = H.partial + 2 * G;
  double* const pu = H.partial + 3 * G;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;

  // zero the outputs; the chain's input is r
  for (int idx = tid; idx < (m + 1) * n0; idx += stride) V[idx] = 0.f;
  for (int idx = tid; idx < m * (m + 1); idx += stride) Hc[idx] = 0.f;
  for (int idx = tid; idx < n0; idx += stride) {
    const float rv = r_in[idx];
    L0.r[idx] = rv;
    L0.x[idx] = __ldg(L0.D + idx) * rv;
  }
  grid.sync();

  // g0 = M r;  beta = ||g0||;  V[0] = g0 / max(beta, eps)
  chain_to_last(H.lv, H.nlev, r_in, H.z1, cycles, grid);
  {
    double acc = 0.0;
    for (int idx = tid; idx < n0; idx += stride) {
      const float g = chain_result_at(L0, H.z1, idx, cycles);
      H.w[idx] = g;
      acc += (double)g * (double)g;
    }
    put_partial(acc, pw, sh);
  }
  grid.sync();
  const float beta = (float)sqrt(grid_total(pw, sh));
  if (leader) *beta_out = beta;
  for (int idx = tid; idx < n0; idx += stride)
    V[idx] = ldw(H.w + idx) / fmaxf(beta, kEps);
  grid.sync();

  float alive = 1.f;
  for (int j = 0; j < m; ++j) {
    const float* vj = V + (size_t)j * n0;
    // the preconditioner's input W_op V[j]
    for (int idx = tid; idx < n0; idx += stride) {
      const float a = apply_at(H.op, vj, idx);
      H.Av[idx] = a;
      L0.r[idx] = a;
      L0.x[idx] = __ldg(L0.D + idx) * a;
    }
    grid.sync();
    chain_to_last(H.lv, H.nlev, H.Av, H.z1, cycles, grid);
    // u = alive * M Av;  w = u;  partials of <V[0], u> and ||u||^2
    {
      double acc = 0.0, accu = 0.0;
      for (int idx = tid; idx < n0; idx += stride) {
        const float u = alive * chain_result_at(L0, H.z1, idx, cycles);
        H.w[idx] = u;
        acc += (double)ldw(V + idx) * (double)u;
        accu += (double)u * (double)u;
      }
      put_partial(acc, pmgs[0], sh);
      put_partial(accu, pu, sh);
    }
    grid.sync();
    // MGS, one stage per term: w -= h_i V[i] with the next term's partial
    for (int i = 0; i <= j; ++i) {
      const float h = (float)grid_total(pmgs[i & 1], sh);
      if (leader) Hc[(size_t)j * (m + 1) + i] = h;
      const float* vi = V + (size_t)i * n0;
      const float* vn = V + (size_t)(i + 1) * n0;
      double acc = 0.0;
      for (int idx = tid; idx < n0; idx += stride) {
        const float wv = ldw(H.w + idx) - h * ldw(vi + idx);
        H.w[idx] = wv;
        acc += (i < j ? (double)ldw(vn + idx) : (double)wv) * (double)wv;
      }
      put_partial(acc, i < j ? pmgs[(i + 1) & 1] : pw, sh);
      grid.sync();
    }
    const float hn = (float)sqrt(grid_total(pw, sh));
    const float unorm = (float)sqrt(grid_total(pu, sh));
    alive = hn > kFreeze * unorm ? alive : 0.f;
    if (leader) Hc[(size_t)j * (m + 1) + j + 1] = alive * hn;
    float* vnext = V + (size_t)(j + 1) * n0;
    for (int idx = tid; idx < n0; idx += stride)
      vnext[idx] = alive * ldw(H.w + idx) / fmaxf(hn, kEps);
    grid.sync();
  }
}

}  // namespace

extern "C" {

int gmg_fused_gmres_desc_bytes() { return (int)sizeof(Hier); }

int gmg_fused_gmres_partial_slots() { return kSlots; }

// Blocks of the cooperative grid for a fine level of `fine_points`.
int gmg_fused_gmres_grid(int fine_points, int* blocks) {
  return coop_grid(gmg_fused_gmres_kernel, fine_points, blocks);
}

// Fill a host buffer of gmg_fused_gmres_desc_bytes() bytes: the levels
// (ptrs, dims, offs as pack_levels takes them), the operator's taps
// (op_K triples (dz, dy, dx) in op_offs; its shape is level 0's) and the work
// vectors Av, z1, w (level-0 size) and partial (kSlots * blocks doubles).
int gmg_fused_gmres_pack(void* out, int nlev, const long long* ptrs,
                         const int* dims, const int* offs, int op_K,
                         const int* op_offs, long long Av, long long z1,
                         long long w, long long partial) {
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
  H->Av = reinterpret_cast<float*>(Av);
  H->z1 = reinterpret_cast<float*>(z1);
  H->w = reinterpret_cast<float*>(w);
  H->partial = reinterpret_cast<double*>(partial);
  H->nlev = nlev;
  return 0;
}

// One Arnoldi cycle of m steps on r with the operator Wop (op_K, nz, ny,
// nx): V (m+1, nz, ny, nx), Hc (m, m+1), beta (1 float) are written.
// desc: the packed descriptor in device memory; blocks from gmg_fused_gmres_grid.
int gmg_fused_gmres_launch(const void* desc, const float* r,
                           const float* Wop, float* V, float* Hc,
                           float* beta, int m, int cycles, int blocks,
                           void* stream) {
  if (m < 1 || cycles < 1) return (int)cudaErrorInvalidValue;
  const Hier* d = static_cast<const Hier*>(desc);
  void* args[] = {(void*)&d,  (void*)&r,    (void*)&Wop, (void*)&V,
                  (void*)&Hc, (void*)&beta, (void*)&m,   (void*)&cycles};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gmg_fused_gmres_kernel, dim3(blocks), dim3(kThreads), args,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
