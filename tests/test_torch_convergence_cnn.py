"""E1's CNN case (quick mode) on the port, fed the JAX runner's inputs.

``benchmarks/convergence.py::run_cnn``, K-AVG and M-AVG at hw=12, 20 meta
steps of P=4 learners x K=4 local steps, runs in JAX; the port's
``run_cnn`` then trains from the same initial params on the same batches
and evaluation set, carried over as numpy arrays. Per-step losses agree
to rtol 1e-5 (5.2e-7 at most, measured; the 3x3 convolutions and matmuls sum in other orders in
XLA:CPU and ATen). Neither arm reaches the 2.2 target, in JAX or in the
port (the loss stays near ln 10 = 2.303), so E1 asserts nothing for the
CNN: samples to target are None in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.convergence import run_cnn as jrun_cnn  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import cnn_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common, convergence  # noqa: E402

torch.set_num_threads(2)

SETTINGS = dict(P=4, K=4, lr=0.1, steps=20)
HW, B = 12, 8


def test_quick_settings_are_the_references():
    model, runner, kw, target = convergence.cases(quick=True)[1]
    assert (model, runner, kw, target) == ("cnn", convergence.run_cnn,
                                           SETTINGS, 2.2)
    assert convergence.CNN_HW == HW


@pytest.mark.parametrize("algo,mu", convergence.ARMS)
def test_cnn_fed_jax_inputs_matches_jax(algo, mu):
    P, K, steps = SETTINGS["P"], SETTINGS["K"], SETTINGS["steps"]
    jlosses, jacc = jrun_cnn(algo, mu=mu, **SETTINGS)
    params = jax.device_get(cnn_init(jax.random.PRNGKey(0), hw=HW,
                                     classes=10))
    bf = classif_batch_fn(HW * HW * 3, 10, P, K, B)
    batches = []
    for i in range(steps):
        b = jax.device_get(bf(jax.random.fold_in(jax.random.PRNGKey(1), i),
                              i))
        batches.append({"x": b["x"].reshape(P, K, B, HW, HW, 3),
                        "y": b["y"]})
    ev = jax.device_get(classif_eval_set(HW * HW * 3, 10, n=512))
    ev = {"x": ev["x"].reshape(-1, HW, HW, 3), "y": ev["y"]}
    losses, acc = convergence.run_cnn(
        algo, mu=mu, **SETTINGS, device="cpu",
        params=interop.params_from_jax(params),
        batch_at=lambda i: interop.params_from_jax(batches[i]),
        eval_set=interop.params_from_jax(ev))
    assert len(losses) == len(jlosses) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert common.samples_to_target(losses, 2.2, P, K, B) is None
    assert common.samples_to_target(jlosses, 2.2, P, K, B) is None
    assert min(losses) > 2.2 and abs(losses[-1] - np.log(10)) < 0.1
    assert abs(acc - jacc) <= 1 / 512 + 1e-9
