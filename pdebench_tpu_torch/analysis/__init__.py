from .gate_analyzer import GateAnalyzer, GateBreakdown
from .error_classifier import ErrorClassifier

__all__ = ["GateAnalyzer", "GateBreakdown", "ErrorClassifier"]
