"""Kernel #6 against its plain version, step by step, on one fixed load
vector of a 3-D Helmholtz case, on a CUDA card.

    python3 scripts/torch_gmres_floor.py [case_id] [--root DIR]

Default case: helmholtz_3d_k1_trig. The oracle's linear solve is captured
once on the card (OracleSolver(device="cuda"); the load vector sums in a
fixed order, so every capture gives the same one). The refinement then
runs with the fused Arnoldi kernel as its inner cycle, and the input of
each outer round's cycle (the residual the round before left) is kept.
On each of the first two rounds' inputs, one m = 30 cycle runs three
ways: the kernel, its plain version (PyTorch float32 on the card) and the
same recurrence in float64 (the plain version's V-cycles and operator in
float64). For the kernel and the plain version, after each step j:

  lsq      the least-squares residual ||beta e1 - H y|| / beta
  true     ||r - A z_j|| / ||r|| with z_j = V[:j] y, A the true operator,
           in float64
  orth     max |<V_i, V_j>| over i < j (loss of orthogonality)
  arnoldi  ||M A V_{j-1} - V[:j+1] H[:, j-1]|| / ||M A V_{j-1}||, M A in
           float64: how well H and V satisfy the recurrence they claim
  dH, dV   max |H_kernel - H_plain| in column j-1 (of its scale) and
           max |V_kernel[j] - V_plain[j]|

and the same true residual for the float64 recurrence. Prints the card's
name and power limit first, a table per round, one JSON line last.

The package comes from the checkout at DIR (default: this script's own),
so that two versions of the kernel can be read on one card.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
STEPS = 30


def f64_raw(fg, r, W_op):
    """The Arnoldi cycle of fg.plain_raw in float64 (its V-cycles, the
    operator and the Gram-Schmidt sums): (V, H, beta)."""
    from pdebench_tpu_torch.solvers import gmg_fused

    d = copy.copy(fg)
    d.W = [w.double() for w in fg.W]
    d.D = [x.double() for x in fg.D]
    d.bands = [[b.double() for b in bl] for bl in fg.bands]
    m, p = fg.m, fg.op_pad
    W64 = W_op.double()
    V = torch.zeros((m + 1,) + fg.shape, dtype=torch.float64, device=r.device)
    H = torch.zeros((m + 1, m), dtype=torch.float64, device=r.device)
    g0 = d._chain(r.double().reshape(fg.shape), gmg_fused.PRECOND_CYCLES)
    beta = torch.sqrt(torch.sum(g0 * g0))
    V[0] = g0 / beta
    for j in range(m):
        w = d._chain(gmg_fused._apply_taps(W64, fg.op_offsets, p, V[j]), gmg_fused.PRECOND_CYCLES)
        for i in range(j + 1):
            H[i, j] = torch.sum(V[i] * w)
            w = w - H[i, j] * V[i]
        H[j + 1, j] = torch.sqrt(torch.sum(w * w))
        V[j + 1] = w / H[j + 1, j]
    return V.reshape(m + 1, -1), H, beta, d


def steps_report(V, H, beta, r, A64, MA64):
    """Per-step readings of one cycle's (V, H, beta), in float64."""
    from pdebench_tpu_torch.solvers.krylov import lstsq_hessenberg

    V, H, beta = V.double(), H.double(), beta.double()
    rn = float(torch.linalg.norm(r))
    out = []
    for j in range(1, H.shape[1] + 1):
        Hj = H[: j + 1, :j]
        y = lstsq_hessenberg(Hj, beta)
        e1 = torch.zeros(j + 1, dtype=torch.float64, device=H.device)
        e1[0] = beta
        lsq = float(torch.linalg.norm(e1 - Hj @ y) / beta)
        z = y @ V[:j]
        true = float(torch.linalg.norm(r - A64(z)) / rn)
        orth = float((V[:j] @ V[j]).abs().max())
        mav = MA64(V[j - 1])
        arn = float(torch.linalg.norm(mav - H[: j + 1, j - 1] @ V[: j + 1]) / torch.linalg.norm(mav))
        out.append(dict(j=j, lsq=lsq, true=true, orth=orth, arnoldi=arn))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", nargs="?", default="helmholtz_3d_k1_trig")
    ap.add_argument("--root", default=ROOT, help="checkout whose package runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gmres_floor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from pdebench_tpu_torch.solvers import dispatch, gmg_fused
    from pdebench_tpu_torch.solvers.stencil import constrain_step_weights
    from torch_ir_rounds import capture

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        config = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == args.case)
    dev = torch.device("cuda")
    (op, b, mask, g, opts), _ = capture(config, "cuda", stop=False)
    (_, b2, _, _, _), _ = capture(config, "cuda", stop=True)
    lat = opts["_lattice32"]
    keep = (1.0 - lat.embedding.embed(mask, True).to(torch.float32)).reshape(lat.grid_shape)
    W32c = constrain_step_weights(lat.W, lat.offsets, keep)
    fg = gmg_fused.build_fused_inner_gmres(lat.gmg, STEPS, dev, lat.offsets)
    inputs = []

    def inner(r):
        inputs.append(r.clone())
        return fg(r, W32c)

    lat.gmg.fused[("gmres", STEPS)] = inner
    _, iters, res, conv, name = dispatch.solve_constrained_ir(
        op, b, mask, g, lat, float(opts.get("rtol", 1e-10)), float(opts.get("atol", 1e-14)),
        inner="gmres", inner_iters=STEPS, max_outer=dispatch.MAX_OUTER,
    )
    out = {"root": args.root, "case": args.case, "load_vector_bitwise_repeatable": bool(torch.equal(b, b2)),
           "rounds": iters // STEPS, "residual": res, "inner": name, "cycles": []}
    print(f"{args.case}: load vector bitwise equal on two captures: "
          f"{out['load_vector_bitwise_repeatable']}; {out['rounds']} rounds, residual {res:.4e}, "
          f"inner {name}", flush=True)

    W64c = W32c.double()
    pad = lat.pad
    A64 = lambda z: gmg_fused._apply_taps(W64c, lat.offsets, pad, z.reshape(fg.shape)).reshape(-1)
    for k, r in enumerate(inputs[:2]):
        Vk, Hk, bk = fg.raw(r, W32c)
        Vp, Hp, bp = fg.plain_raw(r, W32c)
        V64, H64, b64, d64 = f64_raw(fg, r, W32c)
        MA64 = lambda v: d64._chain(A64(v).reshape(fg.shape), gmg_fused.PRECOND_CYCLES).reshape(-1)
        r64 = r.double()
        rk = steps_report(Vk, Hk, bk, r64, A64, MA64)
        rp = steps_report(Vp, Hp, bp, r64, A64, MA64)
        r6 = steps_report(V64, H64, b64, r64, A64, MA64)
        scale = float(Hp.abs().max())
        rows = []
        print(f"round {k + 1} input (||r|| {float(torch.linalg.norm(r64)):.4e}): beta kernel "
              f"{float(bk):.6e}, plain {float(bp):.6e}, f64 {float(b64):.6e}", flush=True)
        print("  j | kernel lsq, true, orth, arnoldi | plain lsq, true, orth, arnoldi | f64 true | dH, dV",
              flush=True)
        for a, p, q in zip(rk, rp, r6):
            j = a["j"]
            dH = float((Hk[:, j - 1] - Hp[:, j - 1]).abs().max()) / scale
            dV = float((Vk[j] - Vp[j]).abs().max())
            rows.append(dict(j=j, kernel=a, plain=p, f64_true=q["true"], dH=dH, dV=dV))
            print(f"  {j:2d} | {a['lsq']:.3e} {a['true']:.3e} {a['orth']:.2e} {a['arnoldi']:.2e} | "
                  f"{p['lsq']:.3e} {p['true']:.3e} {p['orth']:.2e} {p['arnoldi']:.2e} | "
                  f"{q['true']:.3e} | {dH:.2e} {dV:.2e}", flush=True)
        out["cycles"].append(rows)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
