"""The port's mesher against the JAX package's: the masked rectilinear
meshes of the dataset's l_shape and t_junction geometries array-equal to
the reference's, the sampled grid's NaN mask equal, the copied geometry
module array-equal on a signed-distance domain, and the meshes that form
no lattice (periodic_square, distmesh) array-equal to the reference's."""

import json
from pathlib import Path

import numpy as np
import pytest

from pdebench_tpu.fem import geometry as ref_geometry
from pdebench_tpu.fem import sampling as ref_sampling
from pdebench_tpu.fem.spaces import FunctionSpace as RefSpace
from pdebench_tpu.oracle import base as ref_base
from pdebench_tpu_torch.fem import geometry, sampling
from pdebench_tpu_torch.fem.spaces import FunctionSpace
from pdebench_tpu_torch.oracle import base

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"


def _masked_domains():
    """Each distinct l_shape / t_junction geometry of the dataset (the
    keys the mesher reads), with the output grid of its first case."""
    out = {}
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            dom = c["oracle_config"]["domain"]
            if dom["type"] in ("l_shape", "t_junction"):
                key = [dom.get(k) for k in ("type", "geometry_params", "outer_bbox", "cutout_bbox")]
                out.setdefault(json.dumps(key), (dom, c["oracle_config"]["output"]["grid"]))
    return list(out.values())


DOMAINS = _masked_domains()


def test_dataset_has_masked_domains():
    assert {d["type"] for d, _ in DOMAINS} == {"l_shape", "t_junction"} and len(DOMAINS) >= 10


@pytest.mark.parametrize("dom, grid", DOMAINS, ids=[f"{d['type']}-{i}" for i, (d, _) in enumerate(DOMAINS)])
def test_rectilinear_mesh_and_grid_mask_match_reference(dom, grid):
    """Resolution 10: vertices and cells array-equal; P2 dof coordinates
    equal; a nodal field sampled on the case's output grid with the same
    NaN mask (outside the domain) and the same values."""
    spec = {"resolution": 10}
    mesh, ref_mesh = base.build_mesh(dom, spec), ref_base.build_mesh(dom, spec)
    np.testing.assert_array_equal(mesh.coords, np.asarray(ref_mesh.coords))
    np.testing.assert_array_equal(mesh.cells, np.asarray(ref_mesh.cells))
    V, rV = FunctionSpace(mesh, 2), RefSpace(ref_mesh, 2)
    np.testing.assert_array_equal(V.dof_coords, rV.dof_coords)
    u = np.sin(3 * V.dof_coords[:, 0]) + V.dof_coords[:, 1] ** 2
    pts, shape = sampling.grid_points(grid)
    got = sampling.sample_on_grid(V, u, grid, loc=sampling.locate_points(mesh, pts))
    want = ref_sampling.sample_on_grid(rV, u, grid, loc=ref_sampling.locate_points(ref_mesh, pts))
    assert got.shape == shape and np.isnan(got).any() and not np.isnan(got).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14, equal_nan=True)


def test_signed_distance_mesher_copy_matches_reference():
    """The copied geometry module: a distmesh circle and the signed
    distances of several domains, array-equal."""
    spec = {"type": "circle", "geometry_params": {"center": [0.5, 0.5], "radius": 0.5}}
    m = geometry.mesh_domain("circle", spec, 0.25)
    rm = ref_geometry.mesh_domain("circle", spec, 0.25)
    np.testing.assert_array_equal(m.coords, rm.coords)
    np.testing.assert_array_equal(m.cells, rm.cells)
    pts = np.random.default_rng(0).uniform(-0.2, 1.2, (200, 2))
    for dom, _ in DOMAINS[:3] + [(spec, None)]:
        fd, pfix, bbox = geometry.domain_sdf(dom["type"], dom)
        rfd, rpfix, rbbox = ref_geometry.domain_sdf(dom["type"], dom)
        np.testing.assert_array_equal(fd(pts), rfd(pts))
        np.testing.assert_array_equal(pfix, rpfix)
        assert tuple(bbox) == tuple(rbbox)


@pytest.mark.parametrize("dom", [
    {"type": "periodic_square"},
    {"type": "circle", "geometry_params": {"center": [0.5, 0.5], "radius": 0.5}},
    # an l_shape whose re-entrant corner is not on a lattice line of any
    # pitch the mesher takes falls through to distmesh in the reference
    {"type": "l_shape", "geometry_params": {
        "vertices": [[0, 0], [1, 0], [1, 0.5], [0.5, 0.5], [0.2, 1], [0, 1]]}},
])
def test_domains_off_the_lattice_mesh_like_the_reference(dom):
    """Meshes whose dofs form no lattice: periodic_square (a rectangle
    mesh with its periodic bounds), the distmesh circle and an l_shape
    that falls through to distmesh, array-equal to the reference's, and
    flagged as lattice-free before any meshing."""
    spec = {"resolution": 16}
    mesh, ref_mesh = base.build_mesh(dom, spec), ref_base.build_mesh(dom, spec)
    np.testing.assert_array_equal(mesh.coords, np.asarray(ref_mesh.coords))
    np.testing.assert_array_equal(mesh.cells, np.asarray(ref_mesh.cells))
    assert mesh.periodic == ref_mesh.periodic
    assert base.lattice_free_domain(dom)
    # the periodic dofmap identifies the opposite sides in both packages
    V, rV = FunctionSpace(mesh, 2), RefSpace(ref_mesh, 2)
    np.testing.assert_array_equal(V.dofmap, rV.dofmap)
    np.testing.assert_array_equal(V.dof_coords, rV.dof_coords)


def test_clear_setup_caches_clears_the_mesh_cache():
    spec = {"type": "circle", "geometry_params": {"center": [0.5, 0.5], "radius": 0.5}}
    geometry.mesh_domain("circle", spec, 0.25)
    assert geometry._mesh_domain_cached.cache_info().currsize >= 1
    base.clear_setup_caches()
    assert geometry._mesh_domain_cached.cache_info().currsize == 0
