"""The ablations (``benchmarks/ablations.py``) on the port, fed the JAX
runner's inputs: heavy-ball, Nesterov, learner momentum and meta_lr 0.5
and 1.5, quick mode (40 meta steps at P=4, K=4, B=8, lr 0.15).

Each variant trains from JAX's seed-0 params on JAX's
fold_in(PRNGKey(1), i) batches. Per-step losses agree with the JAX run's
to rtol 1e-5, accuracies within one of 2,048 evaluation examples, and the
samples to the 1.1 loss target are JAX's: 1536, 1408, 1024, 2176, 1024.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import ablations as jablations  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import ablations, common  # noqa: E402

torch.set_num_threads(2)

STEPS = 40
EXPECTED_STT = {"heavy_ball": 1536, "nesterov": 1408, "mlocal": 1024,
                "eta_0.5": 2176, "eta_1.5": 1024}


@pytest.fixture(scope="module")
def fed_jax():
    params = jax.device_get(mlp_init(jax.random.PRNGKey(0), 32, 64, 10))
    bf = classif_batch_fn(32, 10, 4, 4, 8)
    batches = [interop.params_from_jax(jax.device_get(
        bf(jax.random.fold_in(jax.random.PRNGKey(1), i), i)))
        for i in range(STEPS)]
    ev = jax.device_get(classif_eval_set(32, 10))
    lines = []
    results = ablations.main(quick=True, device="cpu",
                             params=interop.params_from_jax(params),
                             batch_at=batches.__getitem__,
                             eval_set=interop.params_from_jax(ev),
                             log=lines.append)
    return results, lines


def test_variants_are_the_references():
    assert [t for t, _ in ablations.VARIANTS] == list(EXPECTED_STT)
    assert (ablations.P, ablations.K, ablations.B, ablations.LR) == (
        4, 4, 8, 0.15)
    assert (common.D_IN, common.HIDDEN, common.CLASSES) == (32, 64, 10)


@pytest.mark.parametrize("tag,kw", ablations.VARIANTS)
def test_variant_fed_jax_inputs_matches_jax(fed_jax, tag, kw):
    results, lines = fed_jax
    jlosses, jacc, jstt = jablations.run_cfg(tag, STEPS, **dict(kw))
    losses, acc, stt = results[tag]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert abs(acc - jacc) <= 1 / 2048 + 1e-9
    assert stt == jstt == EXPECTED_STT[tag]
    assert losses[-1] < losses[0]
    assert any(ln.startswith(f"ablations,{tag},final_loss=") for ln in lines)


def test_main_asserts_every_variant_trains(monkeypatch):
    monkeypatch.setattr(ablations, "run_cfg",
                        lambda tag, steps, **kw: ([1.0, 2.0], 0.1, None))
    with pytest.raises(AssertionError):
        ablations.main(quick=True, device="cpu", log=lambda s: None)
