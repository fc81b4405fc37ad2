"""On-device metrics ring: per-step metric rows, one host read per flush
(the JAX package's ``obs/metrics.py``).

Reading a scalar metric with ``float(v)`` blocks the host until the card
has finished the step, so per-step reads turn the asynchronous launch
queue into a lock-step one. The ``MetricsBuffer`` keeps the per-step
metrics on the state's device in a fixed-size (capacity, n_metrics) f32
ring: each meta step writes one row in place (``write_row``: one stack and
one copy, no host read), and ``flush()`` brings the whole window to the
host with one ``.cpu()`` at the ``log_every`` boundaries.

Where the port departs from JAX: JAX writes the row inside the jitted
step, from metric keys found by ``jax.eval_shape``; the port runs
eagerly, so the Trainer takes the keys from step 0's returned metrics and
builds the ring before it writes step 0's row. A metric the step computed
on the host (a Python float, or a tensor on the CPU while the ring lies
on the card) is written with a fill of its f32 value, which needs no
host read either.
"""
from __future__ import annotations

import numpy as np
import torch


def metric_keys(metrics) -> tuple[str, ...]:
    """Stable (sorted) key order of a metrics dict: the column layout of
    the ring."""
    return tuple(sorted(metrics))


def _row(metrics, keys, device) -> torch.Tensor:
    vals = []
    for k in keys:
        v = metrics[k]
        if isinstance(v, torch.Tensor) and v.device == device:
            vals.append(v.detach().reshape(()).to(torch.float32))
        else:  # a host value: its f32 rounding, as jnp.asarray gives it
            with np.errstate(over="ignore"):
                v32 = float(np.float32(float(v)))
            vals.append(torch.full((), v32, dtype=torch.float32,
                                   device=device))
    return torch.stack(vals)


def write_row(buf: torch.Tensor, row: int, metrics, keys) -> torch.Tensor:
    """Write one metric row of ``buf`` (the (capacity, n) f32 ring) in
    place: ``metrics[k]`` for each column ``k`` of ``keys``, cast to f32.
    ``row`` is a Python int. Returns ``buf``."""
    buf[row].copy_(_row(metrics, keys, buf.device))
    return buf


class MetricsBuffer:
    """Host-side handle of the device ring.

    ``keys``       column order (metric name per column)
    ``capacity``   rows before a flush is forced (size to >= log_every)
    ``buf``        the (capacity, n) f32 ring on ``device``
    ``host_syncs`` number of device-to-host reads made: the quantity the
                   telemetry tests pin (no hidden syncs)
    """

    def __init__(self, keys, capacity: int, device="cpu"):
        assert capacity >= 1, capacity
        self.keys = tuple(keys)
        self.capacity = int(capacity)
        self.buf = torch.zeros((self.capacity, len(self.keys)),
                               dtype=torch.float32, device=device)
        self.steps: list[int] = []  # meta_step of each pending row, in order
        self.host_syncs = 0

    @property
    def count(self) -> int:
        """Pending rows since the last flush (the next write's row index)."""
        return len(self.steps)

    @property
    def full(self) -> bool:
        return len(self.steps) >= self.capacity

    def append(self, metrics, step: int) -> None:
        """Write ``metrics`` as the next row, on the device, no host read."""
        if self.full:
            raise RuntimeError(
                f"MetricsBuffer full ({self.capacity} rows) — flush() first")
        write_row(self.buf, self.count, metrics, self.keys)
        self.steps.append(int(step))

    def flush(self) -> list[dict]:
        """Bring every pending row to the host with ONE ``.cpu()``.

        Returns one dict of Python floats per pending step, with
        ``meta_step`` attached, and resets the window. Rows decode bitwise
        as written: f32 on the device, f32 across the copy, widened to a
        Python float only at the dict.
        """
        if not self.steps:
            return []
        rows = self.buf[: len(self.steps)].cpu().numpy()
        self.host_syncs += 1
        out = []
        for s, row in zip(self.steps, rows):
            rec = {k: float(v) for k, v in zip(self.keys, row)}
            rec["meta_step"] = s
            out.append(rec)
        self.steps.clear()
        return out
