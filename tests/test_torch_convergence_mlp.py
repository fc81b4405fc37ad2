"""E1's MLP case (quick mode) on the port, fed the JAX runner's inputs.

``benchmarks/convergence.py``'s MLP case, K-AVG and M-AVG, runs in JAX
(``benchmarks.common.run_mlp``); the port's ``run_mlp`` then trains from
the same initial params on the same batches and evaluation set, carried
over as numpy arrays. Per-step losses agree to rtol 1e-5 over 30 meta
steps of 16 local steps each (1.7e-7 at most, measured): tanh and the
matmul sums differ by a few f32 ulps between XLA:CPU and ATen. The
samples to the 1.0 target are JAX's: 4,352 for K-AVG and 2,304 for M-AVG.
The validation accuracy over 2,048 examples agrees within one example.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.common import run_mlp as jrun_mlp  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common, convergence  # noqa: E402

torch.set_num_threads(2)

SETTINGS = dict(P=4, K=4, lr=0.2, steps=30, batch=16)
EXPECTED_STT = {"kavg": 4352, "mavg": 2304}


def test_quick_settings_are_the_references():
    model, runner, kw, target = convergence.cases(quick=True)[0]
    assert (model, runner, kw, target) == ("mlp", common.run_mlp, SETTINGS,
                                           1.0)
    assert convergence.ARMS == (("kavg", 0.0), ("mavg", 0.7))
    assert (common.D_IN, common.CLASSES, common.HIDDEN) == (32, 10, 64)


@pytest.mark.parametrize("algo,mu", convergence.ARMS)
def test_mlp_fed_jax_inputs_matches_jax(algo, mu):
    P, K, B, steps = (SETTINGS[k] for k in ("P", "K", "batch", "steps"))
    jlosses, jacc = jrun_mlp(algo, mu=mu, **SETTINGS)
    # the runner's own inputs: seed 0 init, fold_in(PRNGKey(1), i) batches
    params = jax.device_get(mlp_init(jax.random.PRNGKey(0), common.D_IN,
                                     common.HIDDEN, common.CLASSES))
    bf = classif_batch_fn(common.D_IN, common.CLASSES, P, K, B)
    batches = [jax.device_get(bf(jax.random.fold_in(jax.random.PRNGKey(1),
                                                    i), i))
               for i in range(steps)]
    ev = jax.device_get(classif_eval_set(common.D_IN, common.CLASSES))
    losses, acc = common.run_mlp(
        algo, mu=mu, **SETTINGS, device="cpu",
        params=interop.params_from_jax(params),
        batch_at=lambda i: interop.params_from_jax(batches[i]),
        eval_set=interop.params_from_jax(ev))
    assert len(losses) == len(jlosses) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    stt = common.samples_to_target(losses, 1.0, P, K, B)
    assert stt == common.samples_to_target(jlosses, 1.0, P, K, B)
    assert stt == EXPECTED_STT[algo]
    assert abs(acc - jacc) <= 1 / 2048 + 1e-9
