"""Universal (PDE-agnostic) solution-quality metrics.

NaN-safe RMSE / MAE / R^2 on the flattened masked grids plus a
Fourier-space RMSE split into equal-width frequency-magnitude bands
(low/mid/high) with ortho-normalized fft2 so Parseval keeps fRMSE on
the spatial-RMSE scale.

Behavioral parity: pdebench/metrics/universal.py:28-199 — same key
names (UNIVERSAL_METRIC_KEYS), same masking rules (finite-both mask,
empty mask -> {}), same band edges (linspace over |freq| with the top
band closed), same NaN->0 before FFT. Computed only for PASS cases by
the driver (run_benchmark.py:568).

Copy of pdebench_tpu/metrics/universal.py.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

UNIVERSAL_METRIC_KEYS: List[str] = [
    "rmse",
    "mae",
    "r2",
    "frmse_low",
    "frmse_mid",
    "frmse_high",
    "frmse_total",
]


def _reference_array(oracle_info: Dict[str, Any]) -> Optional[np.ndarray]:
    ref = oracle_info.get("reference")
    if ref is None:
        return None
    if isinstance(ref, np.ndarray):
        return ref.astype(float)
    arr = np.array(
        [np.nan if v is None else float(v) for v in ref], dtype=float
    )
    shape = oracle_info.get("reference_shape")
    if shape:
        arr = arr.reshape(shape)
    return arr


def _load_agent_solution(agent_output: Path) -> Optional[np.ndarray]:
    try:
        return np.load(Path(agent_output) / "solution.npz")["u"]
    except Exception:
        return None


def spectral_frmse(
    u_agent: np.ndarray, u_ref: np.ndarray, n_bands: int = 3
) -> Dict[str, float]:
    """Per-band Fourier RMSE of the (NaN-zeroed) difference field."""
    diff = u_agent - u_ref
    diff = np.where(np.isfinite(diff), diff, 0.0)
    F = np.fft.fft2(diff, norm="ortho")
    ny, nx = diff.shape
    fy = np.fft.fftfreq(ny)
    fx = np.fft.fftfreq(nx)
    FY, FX = np.meshgrid(fy, fx, indexing="ij")
    mag = np.hypot(FX, FY)
    fmax = mag.max()
    if fmax < 1e-15:
        return {}
    labels = (
        ["low", "mid", "high"]
        if n_bands == 3
        else [f"band_{i}" for i in range(n_bands)]
    )
    edges = np.linspace(0.0, fmax, n_bands + 1)
    out: Dict[str, float] = {}
    total_sq, total_n = 0.0, 0
    for i in range(n_bands):
        lo, hi = edges[i], edges[i + 1]
        m = (mag >= lo) & ((mag < hi) if i < n_bands - 1 else (mag <= hi))
        coeffs = F[m]
        if coeffs.size == 0:
            continue
        sq = np.abs(coeffs) ** 2
        out[f"frmse_{labels[i]}"] = float(math.sqrt(float(sq.mean())))
        total_sq += float(sq.sum())
        total_n += coeffs.size
    if total_n:
        out["frmse_total"] = float(math.sqrt(total_sq / total_n))
    return out


def compute_metrics_from_arrays(
    u_agent: np.ndarray, u_ref: np.ndarray
) -> Dict[str, Any]:
    """Metrics on in-memory grids (shapes must match)."""
    if u_agent.shape != u_ref.shape:
        return {}
    mask = np.isfinite(u_agent) & np.isfinite(u_ref)
    if not mask.any():
        return {}
    a, r = u_agent[mask], u_ref[mask]
    diff = a - r
    ss_res = float(np.sum(diff**2))
    ss_tot = float(np.sum((r - r.mean()) ** 2))
    if ss_tot < 1e-30:
        r2 = 1.0 if ss_res < 1e-30 else float("-inf")
    else:
        r2 = 1.0 - ss_res / ss_tot
    metrics: Dict[str, Any] = {
        "rmse": float(np.sqrt(np.mean(diff**2))),
        "mae": float(np.mean(np.abs(diff))),
        "r2": r2,
    }
    if u_agent.ndim == 2:
        metrics.update(spectral_frmse(u_agent, u_ref))
    return metrics


def compute_universal_metrics(
    agent_output: Path, oracle_info: Dict[str, Any]
) -> Dict[str, Any]:
    """File-based entry matching the reference driver's call shape.

    Reads agent_output/solution.npz ("u") and oracle_info["reference"]
    (flat list with None as NaN + "reference_shape"). Never raises;
    returns {} on any load/shape failure.
    """
    u_agent = _load_agent_solution(agent_output)
    if u_agent is None:
        return {}
    u_ref = _reference_array(oracle_info)
    if u_ref is None:
        return {}
    if u_ref.ndim == 1 and u_ref.size == u_agent.size:
        u_ref = u_ref.reshape(u_agent.shape)
    if u_agent.shape != u_ref.shape:
        return {}
    return compute_metrics_from_arrays(u_agent, u_ref)
