from .oracle import OracleSolver  # noqa: F401
from .types import OracleResult, compute_rel_L2_grid  # noqa: F401
