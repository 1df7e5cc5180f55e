"""pdebench_tpu_torch must not import jax or the JAX package.

The scan is static (source text): the test process has jax imported
already, so a sys.modules check could not tell anything apart.
"""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pdebench_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

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
