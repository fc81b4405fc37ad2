"""E3 (``benchmarks/k_sweep.py``, Lemmas 5 and 7) on the port, fed the JAX
runner's inputs.

The JAX sweep runs in quick mode (seed 0, K in 1..16 at N = 128 / K meta
steps, mu 0 and 0.7); the port's ``k_sweep.main`` trains every cell from
JAX's initial params on JAX's batches and evaluation set. Per-step losses
agree to rtol 1e-5, each accuracy within one of the 2,048 evaluation
examples, and the verdicts are JAX's: K_opt 1 at mu 0 and at mu 0.7, and
16 once the time proxy prices communication at the reference's
``comm_ratio`` of 14 (a TPU dry-run input, labelled so in the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.common import run_mlp as jrun_mlp  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common, k_sweep  # noqa: E402

torch.set_num_threads(2)

MU0_ACC = {1: 0.7305, 2: 0.7212, 4: 0.7261, 8: 0.7217, 16: 0.7095}


def jax_inputs(*, P, K, batch, seed):
    """``run_mlp`` overrides carrying JAX's own draws of one run."""
    steps = k_sweep.TOTAL_LOCAL_STEPS // K
    params = jax.device_get(mlp_init(jax.random.PRNGKey(seed), common.D_IN,
                                     common.HIDDEN, common.CLASSES))
    bf = classif_batch_fn(common.D_IN, common.CLASSES, P, K, batch)
    key = jax.random.PRNGKey(seed + 1)
    batches = [interop.params_from_jax(jax.device_get(
        bf(jax.random.fold_in(key, i), i))) for i in range(steps)]
    ev = jax.device_get(classif_eval_set(common.D_IN, common.CLASSES))
    return dict(params=interop.params_from_jax(params),
                batch_at=batches.__getitem__,
                eval_set=interop.params_from_jax(ev))


def test_settings_are_the_references():
    from benchmarks import k_sweep as jk

    assert k_sweep.KS == jk.KS
    assert k_sweep.TOTAL_LOCAL_STEPS == jk.TOTAL_LOCAL_STEPS
    assert k_sweep.time_proxy(14.0) == jk._time_proxy(None, 14.0)
    assert k_sweep.COMM_RATIO == 14.0


@pytest.mark.parametrize("mu", [0.0, 0.7])
def test_sweep_fed_jax_inputs_matches_jax(mu):
    accs, curves = k_sweep.sweep(mu, (0,), device="cpu", inputs=jax_inputs,
                                 log=lambda s: None)
    for K in k_sweep.KS:
        jlosses, jacc = jrun_mlp("mavg", P=4, K=K, mu=mu, lr=0.15,
                                 steps=128 // K, batch=8, seed=0)
        np.testing.assert_allclose(curves[K][0], jlosses, rtol=1e-5)
        assert abs(accs[K] - jacc) <= 1 / 2048 + 1e-9, (mu, K)
    if mu == 0.0:
        assert {K: round(a, 4) for K, a in accs.items()} == MU0_ACC
    assert max(accs, key=accs.get) == 1


def test_main_fed_jax_inputs_gives_the_references_verdicts():
    lines = []
    acc0, acc7, k_opt_time = k_sweep.main(quick=True, device="cpu",
                                          inputs=jax_inputs,
                                          log=lines.append)
    assert max(acc0, key=acc0.get) == 1 and max(acc7, key=acc7.get) == 1
    assert k_opt_time == 16
    assert "k_sweep,K_opt_statistical(mu=0)=1,K_opt(mu=0.7)=1" in lines
    assert ("k_sweep,comm_ratio=14.0,reference TPU dry-run ratio, not "
            "measured here") in lines
    assert lines[-1] == "k_sweep,K_opt_with_comm_cost=16"


@pytest.mark.parametrize("acc0,acc7,raises", [
    ({1: 0.9, 2: 0.8, 4: 0.8, 8: 0.8, 16: 0.8}, None, True),  # Lemma 5
    ({1: 0.7, 2: 0.8, 4: 0.7, 8: 0.7, 16: 0.7},
     {1: 0.7, 2: 0.7, 4: 0.7, 8: 0.7, 16: 0.9}, True),  # Lemma 7
    ({1: 0.7, 2: 0.8, 4: 0.7, 8: 0.7, 16: 0.7},
     {1: 0.7, 2: 0.9, 4: 0.7, 8: 0.7, 16: 0.7}, False),
])
def test_main_asserts_what_the_reference_asserts(monkeypatch, acc0, acc7,
                                                 raises):
    tables = {0.0: acc0, 0.7: acc7 or acc0}
    monkeypatch.setattr(k_sweep, "sweep",
                        lambda mu, *a, **k: (tables[mu], {}))
    if raises:
        with pytest.raises(AssertionError):
            k_sweep.main(quick=True, device="cpu", log=lambda s: None)
    else:
        assert k_sweep.main(quick=True, device="cpu",
                            log=lambda s: None)[2] > 1


def test_quick_on_the_ports_own_stream_fails_lemma_7():
    """The departure ROADMAP Queue 3 records: on the port's own seeded
    CPU stream, quick mode's accuracies put K_opt at 4 for mu 0 and at 16
    for mu 0.7 (JAX's stream: 1 and 1), and the reference's Lemma 7
    assertion fails; the assertion stays as the reference has it."""
    lines = []
    with pytest.raises(AssertionError, match=r"\(4, 16\)"):
        k_sweep.main(quick=True, device="cpu", log=lines.append)
    assert "k_sweep,K_opt_statistical(mu=0)=4,K_opt(mu=0.7)=16" in lines
