"""pdebench_tpu_torch must not import jax or the JAX package.

The scan is static (source text): the test process has jax imported
already, so a sys.modules check could not tell anything apart.
"""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pdebench_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|pdebench_tpu)\b|from\s+(jax|pdebench_tpu)\b)",
    re.MULTILINE,
)


def test_package_has_sources():
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    for expected in (
        "_build.py", "fem/assemble.py", "oracle/poisson.py",
        "solvers/gmg_fused.py", "solvers/stencil_kernel.py",
    ):
        assert expected in names
    assert (PKG / "csrc" / "stencil_apply.cu").is_file()
    assert (PKG / "csrc" / "gmg_fused_cg.cu").is_file()


def test_helmholtz_slice_sources():
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    for expected in ("oracle/helmholtz.py", "solvers/amg.py", "solvers/krylov.py"):
        assert expected in names
    for src in ("gmg_vcycle.cuh", "gmg_fused_gmres.cu"):
        assert (PKG / "csrc" / src).is_file()
    assert (ROOT / "scripts" / "torch_profile_solve.py") in SOURCES


def test_elasticity_slice_sources():
    assert PKG / "oracle" / "linear_elasticity.py" in SOURCES
    assert (PKG / "csrc" / "gmg_fused_block_cg.cu").is_file()


def test_navier_stokes_slice_sources():
    for name in ("oracle/navier_stokes.py", "oracle/mixed.py", "solvers/gmg_dyn.py",
                 "solvers/saddle_stencil.py"):
        assert PKG / name in SOURCES
    for src in ("gmg_fused_dyn_block.cu", "gmg_block_vcycle.cuh"):
        assert (PKG / "csrc" / src).is_file()


def test_stokes_slice_sources():
    assert PKG / "oracle" / "stokes.py" in SOURCES
    src = (PKG / "csrc" / "stencil_apply.cu").read_text()
    assert "stencil_apply_block3_f32" in src and "stencil_apply_block3_f64" in src


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_pattern_catches_imports():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "  from pdebench_tpu.fem import mesh", "import pdebench_tpu"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("from pdebench_tpu_torch.fem import mesh", "# uses jax", "x = 'jax'"):
        assert not _FORBIDDEN.search(ok), ok


def test_wave_slice_sources():
    for name in ("oracle/wave.py", "fem/geometry.py"):
        assert PKG / name in SOURCES


def test_off_lattice_slice_sources():
    for name in ("solvers/amg.py", "solvers/krylov.py", "fem/geometry.py", "oracle/base.py"):
        assert PKG / name in SOURCES
    assert (ROOT / "scripts" / "torch_sweep_cases.py") in SOURCES


def test_cell_local_slice_sources():
    """The modules of the cell-local step loops and the last SA-AMG
    preconditioners are scanned."""
    for name in ("solvers/dispatch.py", "solvers/amg.py", "fem/assemble.py", "oracle/base.py",
                 "oracle/heat.py", "oracle/scalar.py", "oracle/wave.py", "oracle/burgers.py",
                 "oracle/reaction_diffusion.py", "oracle/convection_diffusion.py",
                 "oracle/mixed.py", "oracle/stokes.py"):
        assert PKG / name in SOURCES


def test_last_types_slice_sources():
    """The modules of the last oracle types (Darcy with the copied H(div)
    spaces, hyperelasticity, Cahn-Hilliard) and of the 3-D elasticity
    route are scanned."""
    for name in ("fem/hdiv.py", "oracle/darcy.py", "oracle/hyperelasticity.py",
                 "oracle/cahn_hilliard.py", "oracle/oracle.py", "oracle/linear_elasticity.py",
                 "oracle/scalar.py", "solvers/dispatch.py", "solvers/gmg.py"):
        assert PKG / name in SOURCES


def test_harness_slice_sources():
    """The harness modules, both driver twins and the docs are scanned or
    present."""
    for name in (
        "oracle/cpp_backend.py", "oracle/runner.py", "oracle/oracle.py",
        "metrics/__init__.py", "metrics/universal.py", "metrics/specialized.py",
        "metrics/scoring.py", "metrics/tier_levels.py",
        "analysis/__init__.py", "analysis/gate_analyzer.py", "analysis/error_classifier.py",
        "core/__init__.py", "core/prompt_builder.py", "core/llm_client.py",
        "core/feedback_prompt.py", "core/multi_attempt.py",
        "agents/__init__.py", "agents/base_agent.py", "agents/agent_registry.py",
        "agents/wrappers.py",
        "sandbox/__init__.py", "sandbox/executor.py", "sandbox/cpp_executor.py",
    ):
        assert PKG / name in SOURCES, name
    for script in ("torch_run_benchmark.py", "torch_test_oracle_cases.py"):
        assert ROOT / "scripts" / script in SOURCES
    for doc in ("PDEBENCH_TPU_TORCH_GUIDE.md", "PYTHON_GUIDE.md", "CPP_GUIDE.md"):
        assert (PKG / "docs" / doc).is_file()


def test_torch_guide_examples_import_no_jax():
    """Every python block of the torch library's guide (what an agent is
    taught to write) imports neither jax nor pdebench_tpu."""
    text = (PKG / "docs" / "PDEBENCH_TPU_TORCH_GUIDE.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, flags=re.S)
    assert len(blocks) >= 10
    for block in blocks:
        assert not _FORBIDDEN.findall(block), block[:200]
        assert "jax" not in block
    assert sum("from pdebench_tpu_torch" in b for b in blocks) >= 5


def test_parallel_slice_sources():
    for name in ("parallel/__init__.py", "parallel/group.py", "parallel/sharded.py",
                 "parallel/halo.py", "parallel/dryrun.py"):
        assert PKG / name in SOURCES
