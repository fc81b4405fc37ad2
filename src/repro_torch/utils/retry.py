"""Bounded retry with exponential backoff for transient I/O errors (the
JAX package's ``utils/retry.py``, kept as a copy so the port imports
nothing of it).

Checkpoint writes (``repro_torch.checkpoint.npz``) go through it, so a
transient ``OSError`` (an NFS hiccup, disk-pressure EAGAIN, a flaky
container overlay) costs a few milliseconds of backoff instead of a dead
run. It retries the transient failure classes only and re-raises the last
error when the budget is spent: a broken path fails loudly after
``attempts`` tries, never silently.

Backoff jitter is seeded and deterministic: every delay is a pure function
of ``(seed, i)``, never of the wall clock or the global RNG state, so a
run's retry schedule replays exactly.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Tuple, Type


def backoff_schedule(
    attempts: int,
    *,
    base_delay: float = 0.05,
    factor: float = 2.0,
    jitter: float = 0.0,
    seed: int = 0,
) -> list:
    """The deterministic sleep schedule ``retry_io`` uses: one delay per
    failed attempt that still has retries left (``attempts - 1`` entries).

    Delay i is ``base_delay * factor**i * (1 + jitter * u_i)`` with
    ``u_i`` drawn uniformly from [0, 1) by a ``random.Random(seed)``
    private to this call; ``jitter=0`` (the default) is the plain
    exponential schedule, and equal ``(seed, jitter)`` give equal
    schedules.
    """
    assert attempts >= 1, attempts
    assert jitter >= 0.0, jitter
    rng = random.Random(seed)
    return [
        base_delay * factor**i * (1.0 + jitter * rng.random())
        for i in range(attempts - 1)
    ]


def retry_io(
    fn: Callable,
    *,
    attempts: int = 4,
    base_delay: float = 0.05,
    factor: float = 2.0,
    jitter: float = 0.0,
    seed: int = 0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()``; on ``retry_on`` retry up to ``attempts`` times in
    all, sleeping per ``backoff_schedule`` between tries. Returns
    ``fn()``'s value; re-raises the last exception when every attempt
    failed. ``sleep`` is injectable so tests can observe or suppress the
    backoff."""
    delays = backoff_schedule(
        attempts, base_delay=base_delay, factor=factor, jitter=jitter,
        seed=seed,
    )
    for i in range(attempts):
        try:
            return fn()
        except retry_on:
            if i == attempts - 1:
                raise
            sleep(delays[i])
