# Byzantine-tolerant meta aggregation (the JAX package's repro.robust,
# DESIGN.md §14): robust estimators over the learner stack through the
# robust_reduce kernel, per-learner norm clipping to a trailing-median
# displacement budget, and Krum-style anomaly scores. MAvgConfig.robust=None
# leaves every code path as it is.
from repro_torch.robust.aggregator import (
    ROBUST_METRIC_PREFIX,
    RobustAggregator,
    anomaly_scores,
    make_robust,
    robust_ring_buffers,
)

__all__ = [
    "ROBUST_METRIC_PREFIX",
    "RobustAggregator",
    "anomaly_scores",
    "make_robust",
    "robust_ring_buffers",
]
