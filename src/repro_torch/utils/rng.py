"""Seeded random streams: one ``torch.Generator`` per purpose, keyed on a
tuple of integers, reproducible run to run and independent of the
process's hash seed."""
from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)
