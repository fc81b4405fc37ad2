# Deterministic fault injection (the JAX package's repro.chaos, DESIGN.md
# §13): a seeded, replayable FaultSchedule compiled from a frozen
# ChaosConfig, and the injectors of the data (NaN/Inf batches), comm
# (payload scale and bit-flip) and topology (crash windows onto the elastic
# membership) layers; the save faults go to the checkpoint writer through
# the Trainer. Straggle faults (the async server) are compiled but raise
# where they would be consumed: ROADMAP Queue 1, item 6. Recovery is the
# supervisor's (core/supervisor.py).
from repro_torch.chaos.config import (
    FAULT_KINDS,
    STANDARD_KINDS,
    ChaosConfig,
    FaultSpec,
    standard_chaos,
)
from repro_torch.chaos.inject import (
    PayloadCorruptor,
    apply_chaos,
    wrap_batch_fn,
)
from repro_torch.chaos.schedule import FaultSchedule

__all__ = [
    "FAULT_KINDS",
    "STANDARD_KINDS",
    "ChaosConfig",
    "FaultSchedule",
    "FaultSpec",
    "PayloadCorruptor",
    "apply_chaos",
    "standard_chaos",
    "wrap_batch_fn",
]
