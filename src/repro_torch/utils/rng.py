"""Seeded random streams: one ``torch.Generator`` per purpose, keyed on a
tuple of integers, reproducible run to run and independent of the
process's hash seed."""
from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``. The
    meta device (the cost model's) draws no numbers and has no generator:
    a host generator stands in, which meta tensors accept."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    if torch.device(device).type == "meta":
        device = "cpu"
    return torch.Generator(device=device).manual_seed(seed)
