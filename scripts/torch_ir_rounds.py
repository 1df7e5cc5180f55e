"""Outer rounds of one dataset case's linear solve, solved again and again
on a CUDA card, for a fixed right-hand side and for several.

    python3 scripts/torch_ir_rounds.py [case_id] [--captures N] [--repeats N]

Default case: helmholtz_3d_k1_trig. The oracle's linear solve is captured
N times on the card (OracleSolver(device="cuda"), setup caches cleared
before each, so the load vector b is assembled anew each time; it sums
in a fixed order, so the captures should agree bitwise), and once on the
CPU (OracleSolver(device="cpu"), stopped at its linear solve; its b is
moved to the card). The fused inner the case's route takes on the card:
kernel #2's 25 PCG steps (a symmetric solve), kernel #6's Arnoldi cycle
(GMRES, at least dispatch.FUSED_ARNOLDI_MIN_DOFS dofs) or kernel #3's
chain as the preconditioner of the PyTorch GMRES(30) (fewer). For each b,
on the first capture's operator and lattice:

  - how far b lies from the first capture's (max |b - b_0| / max |b_0|);
  - `dispatch.solve_constrained_ir` run `repeats` times with the kernel:
    the outer rounds and the final residual of each run (a fixed b must
    give fixed rounds: the kernels sum in a fixed order);
  - the residual after each outer round (after the last only, on the
    Richardson route), with the kernel and with its plain version
    (PyTorch ops on the card), against the solve's tolerance
    max(rtol ||rhs||, atol).

Prints the card's name and power limit first, one line per b and route,
and last one JSON line with the numbers.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CG_STEPS = 25  # the fused PCG steps per outer round
STEPS = 30  # the Arnoldi cycle's steps (the GMRES restart), one cycle per outer round


class _Stop(Exception):
    pass


def capture(config, device: str, stop: bool):
    """The arguments of the oracle's linear solve of `config` on `device`;
    with `stop`, the solve itself is not run."""
    from pdebench_tpu_torch.oracle import OracleSolver, base

    module = importlib.import_module(f"pdebench_tpu_torch.oracle.{config['pde']['type']}")
    inner = module.solve_linear
    seen = []

    def capturing(*args, **kwargs):
        seen.append((args, kwargs))
        if stop:
            raise _Stop
        return inner(*args, **kwargs)

    module.solve_linear = capturing
    try:
        base.clear_setup_caches()
        OracleSolver(device=device).solve(copy.deepcopy(config))
    except _Stop:
        pass
    finally:
        module.solve_linear = inner
    return seen[-1]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", nargs="?", default="helmholtz_3d_k1_trig")
    ap.add_argument("--captures", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ir_rounds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch.solvers import dispatch, gmg_fused, krylov
    from pdebench_tpu_torch.solvers.stencil import constrain_step_weights

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        config = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == args.case)
    dev = torch.device("cuda")

    caps = [capture(config, "cuda", stop=False) for _ in range(args.captures)]
    (op, b0, mask, g, opts), kw0 = caps[0]
    symmetric = kw0.get("symmetric", caps[0][0][5] if len(caps[0][0]) > 5 else True)
    rhs_all = {f"cuda{i}": c[0][1] for i, c in enumerate(caps)}
    (_, b_cpu, _, g_cpu, _), _ = capture(config, "cpu", stop=True)
    rhs_all["cpu"] = b_cpu.to(dev)
    g_gap = float((g_cpu.to(dev) - g).abs().max())
    lat = opts["_lattice32"]
    rtol, atol = float(opts.get("rtol", 1e-10)), float(opts.get("atol", 1e-14))

    # the fused inner, by the kernel or by its plain version, put where
    # dispatch looks the hierarchy's fused inner up
    seen_norms = []

    def recording(fn):
        def inner(r):
            seen_norms.append(float(torch.linalg.norm(r.double())))
            return fn(r)
        return inner

    if symmetric:
        inner, steps, fused_key, name = "cg", CG_STEPS, ("cg", CG_STEPS), "fused-cg-cuda"
        fc = gmg_fused.build_fused_inner_cg(lat.gmg, CG_STEPS, dev)
        inners = {"kernel": recording(fc), "plain": recording(fc.plain)}
    elif op.ndof >= dispatch.FUSED_ARNOLDI_MIN_DOFS:
        inner, steps, fused_key, name = "gmres", STEPS, ("gmres", STEPS), "fused-gmres-cuda"
        keep = (1.0 - lat.embedding.embed(mask, True).to(torch.float32)).reshape(lat.grid_shape)
        W32c = constrain_step_weights(lat.W, lat.offsets, keep)
        fg = gmg_fused.build_fused_inner_gmres(lat.gmg, STEPS, dev, lat.offsets)
        inners = {
            "kernel": recording(lambda r: fg(r, W32c)),
            "plain": recording(lambda r: fg.plain(r, W32c)),
        }
    else:
        # the chain preconditions every GMRES step: no per-round record
        inner, steps, name = "gmres", STEPS, "gmres+fused-richardson-cuda"
        fused_key = ("richardson", dispatch.RICHARDSON_CYCLES)
        rich = gmg_fused.build_fused_richardson(lat.gmg, dispatch.RICHARDSON_CYCLES, dev)
        inners = {"kernel": rich, "plain": rich.plain}
    tols = []
    tolerance = krylov._tolerance
    krylov._tolerance = lambda *a: tols.append(tolerance(*a)) or tols[-1]

    def solve(b, route):
        """(outer rounds, final residual, residual after each round)."""
        lat.gmg.fused[fused_key] = inners[route]
        seen_norms.clear()
        x, iters, res, conv, got = dispatch.solve_constrained_ir(
            op, b, mask, g, lat, rtol, atol, inner=inner, inner_iters=steps,
            max_outer=dispatch.MAX_OUTER,
        )
        if not conv or got != name:
            raise AssertionError(f"{route}: converged {conv}, inner {got}")
        # the norm of each round's inner input is the residual the round
        # before left (in float32 lattice order)
        return iters // steps, res, seen_norms[1:] + [res]

    out = {"case": args.case, "inner": name, "g_cpu_gap": g_gap, "rhs": {}}
    print(f"{args.case}: {op.ndof} dofs, inner {name}; boundary values CPU vs card max |diff| "
          f"{g_gap:.3e}", flush=True)
    for key, b in rhs_all.items():
        gap = float((b - b0).abs().max() / b0.abs().max())
        runs = [solve(b, "kernel") for _ in range(args.repeats)]
        plain = solve(b, "plain")
        tol = tols[-1]
        rec = dict(
            b_gap=gap, bitwise_equal=bool(torch.equal(b, b0)), tol=tol,
            kernel_rounds=[r[0] for r in runs], kernel_final=[r[1] for r in runs],
            kernel_per_round=runs[0][2], plain_rounds=plain[0], plain_per_round=plain[2],
        )
        out["rhs"][key] = rec
        fmt = lambda rs: ", ".join(f"{v:.4e}" for v in rs)
        print(f"b {key}: max |b - b_cuda0| / max |b_cuda0| {gap:.3e} (bitwise equal "
              f"{rec['bitwise_equal']}); tolerance {tol:.4e}", flush=True)
        print(f"  kernel x{args.repeats}: rounds {rec['kernel_rounds']}, final {fmt(rec['kernel_final'])}; "
              f"per round {fmt(rec['kernel_per_round'])}", flush=True)
        print(f"  plain: rounds {rec['plain_rounds']}; per round {fmt(rec['plain_per_round'])}", flush=True)
    krylov._tolerance = tolerance
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
