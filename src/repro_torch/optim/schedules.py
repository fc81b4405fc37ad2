"""Step-size schedules for the learner lr (gamma_n in the paper).

Each returns a float32 (``numpy.float32``) computed the way the JAX
package's ``optim/schedules.py`` computes it: Python-number arithmetic
is rounded to float32 where JAX's weak typing rounds it, and the rest
runs in float32, so the lr that reaches the SGD kernel is the float32
that JAX's meta step uses. The one exception is the cosine itself: it is
the double-precision cosine rounded to float32, while XLA's float32
cosine is not always correctly rounded. They differ by 1 ulp on about 1%
of steps, which moves such a step's lr by at most 2 ulps (pinned in
tests/test_torch_slice.py); warmup and constant steps are exact.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def constant(lr):
    return lambda step: F32(lr)


def cosine(lr, total_steps, final_frac=0.1):
    def f(step):
        t = np.minimum(F32(step / max(1, total_steps)), F32(1.0))
        c = F32(np.cos(np.float64(F32(np.pi) * t)))
        return F32(F32(lr) * (F32(final_frac)
                              + F32((1 - final_frac) * 0.5) * (F32(1) + c)))

    return f


def warmup_cosine(lr, warmup_steps, total_steps, final_frac=0.1):
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay
    over the remaining ``total_steps - warmup_steps`` (re-based at the
    warmup end, continuous there)."""
    cos = cosine(lr, max(1, total_steps - warmup_steps), final_frac)

    def f(step):
        if step < warmup_steps:
            return F32(lr * (step + 1) / max(1, warmup_steps))
        return cos(step - warmup_steps)

    return f
