"""Backend-agnostic oracle result type + the primary error metric.

Parity: pdebench/oracle/_types.py:15-35 (OracleResult dataclass and the
NaN-masked rel-L2 grid metric with absolute-norm fallback).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class OracleResult:
    baseline_error: float
    baseline_time: float
    reference: Optional[np.ndarray]  # (ny, nx) or (nz, ny, nx), NaN outside
    solver_info: Dict[str, Any] = field(default_factory=dict)
    num_dofs: int = 0


def compute_rel_L2_grid(u1: np.ndarray, u2: np.ndarray) -> float:
    """NaN-masked relative L2 between two grids of equal shape.

    Points that are NaN in either grid are excluded. If the reference norm
    underflows (< 1e-15), the absolute error norm is returned instead.
    """
    a = np.asarray(u1, dtype=np.float64)
    b = np.asarray(u2, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    m = ~(np.isnan(a) | np.isnan(b))
    if not np.any(m):
        return float("nan")
    diff = np.linalg.norm(a[m] - b[m])
    ref = np.linalg.norm(b[m])
    if ref < 1e-15:
        return float(diff)
    return float(diff / ref)
