# Pluggable compressed meta-communication: the Reducer protocol, its
# implementations, and the factory keyed on MAvgConfig.comm.
from repro_torch.comm.quant import QuantReducer, seeded_dither
from repro_torch.comm.reducer import (
    CompressedReducer,
    DenseReducer,
    ErrorFeedback,
    Reducer,
    dense_bytes,
    make_reducer,
    make_reducer_for,
    reducer_residual,
    uses_error_feedback,
)
from repro_torch.comm.topk import TopKReducer

__all__ = [
    "CompressedReducer",
    "DenseReducer",
    "ErrorFeedback",
    "QuantReducer",
    "Reducer",
    "TopKReducer",
    "dense_bytes",
    "make_reducer",
    "make_reducer_for",
    "reducer_residual",
    "seeded_dither",
    "uses_error_feedback",
]
