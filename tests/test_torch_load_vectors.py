"""Load vectors of the scalar and elasticity oracles against the reference.

The port sums the cell contributions of a load vector through a
fixed-order gather-sum (ScalarContext.load_vector, fem.assemble.GatherSum)
where the reference scatter-adds them: equal to 1e-12 relative (float64
summation order), and bitwise the same on every build and every call.
Dataset cases at cut mesh resolutions and output grids, 2-D P1 / P2, 3-D
P2, and 2-D P2 elasticity (a vector load on the blocked dofmap).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem import symbolic as ref_symbolic
from pdebench_tpu.oracle import scalar as ref_scalar
from pdebench_tpu_torch.fem import symbolic
from pdebench_tpu_torch.oracle import base, scalar

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

TOL = 1e-12
DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
CASES = {
    # case id -> mesh resolution
    "poisson_basic": 12,
    "poisson_p2": 8,
    "poisson_3d_smooth_trig": 3,
    "linear_elasticity_nu010": 6,
}


def _config(cid):
    with open(DATA) as fh:
        config = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == cid)
    config = copy.deepcopy(config)
    config["mesh"]["resolution"] = CASES[cid]
    for axis in ("nx", "ny", "nz"):
        if axis in config["output"]["grid"]:
            config["output"]["grid"][axis] = 5
    return config


def _sources(config):
    src = config["pde"]["source_term"]
    return src if isinstance(src, list) else [src]


def _port_load(config):
    """The port's load vector, as the oracles assemble it: a scalar
    source on the scalar space, a vector one on the blocked space."""
    src = _sources(config)
    ctx = scalar.setup_scalar(config, "cpu", ncomp=-1 if len(src) > 1 else 1)
    if len(src) == 1:
        f_q = symbolic.lambdify_spatial(src[0], ctx.dim, "cpu")(ctx.qpts())
    else:
        f_q = np.stack([symbolic.lambdify_numpy(s, ctx.dim)(ctx.qpts()) for s in src], axis=-1)
    return ctx, f_q


def _ref_load(config):
    src = _sources(config)
    ctx = ref_scalar.setup_scalar(config, ncomp=-1 if len(src) > 1 else 1)
    if len(src) == 1:
        return np.asarray(ctx.load_vector(ref_symbolic.lambdify_spatial(src[0], ctx.dim)(ctx.qpts())))
    f_q = np.stack([ref_symbolic.lambdify_numpy(s, ctx.dim)(ctx.qpts()) for s in src], axis=-1)
    return np.asarray(ref_assemble.scatter_add(
        ref_assemble.local_vector_load(ctx.cb, f_q), np.asarray(ctx.space.dofmap), ctx.space.ndof
    ))


@pytest.mark.parametrize("cid", list(CASES))
def test_load_vector_matches_reference(cid):
    config = _config(cid)
    base.clear_setup_caches()
    ctx, f_q = _port_load(config)
    b = ctx.load_vector(f_q)
    b_ref = _ref_load(config)
    assert b.dtype == torch.float64 and b.shape == (ctx.space.ndof,)
    rel = float(np.abs(b.numpy() - b_ref).max() / np.abs(b_ref).max())
    assert rel < TOL, rel


@pytest.mark.parametrize("cid", list(CASES))
def test_load_vector_bitwise_repeatable(cid):
    """Two builds of the gather-sum (caches cleared between them) and two
    calls on each give the same bits."""
    config = _config(cid)
    got = []
    for _ in range(2):
        base.clear_setup_caches()
        ctx, f_q = _port_load(config)
        got += [ctx.load_vector(f_q), ctx.load_vector(f_q)]
    assert all(torch.equal(got[0], g) for g in got[1:])
