from .universal import UNIVERSAL_METRIC_KEYS, compute_universal_metrics
from .scoring import compute_score, compute_weighted_score
from .tier_levels import check_tier_levels, generate_tier_levels
from .specialized import get_specialized_metrics_computer

__all__ = [
    "UNIVERSAL_METRIC_KEYS",
    "compute_universal_metrics",
    "compute_score",
    "compute_weighted_score",
    "check_tier_levels",
    "generate_tier_levels",
    "get_specialized_metrics_computer",
]
