"""E2 (``benchmarks/mu_p_sweep.py``, Lemma 6) on the port, fed the JAX
runner's inputs.

The JAX sweep runs in quick mode (one seed, 40 meta steps a cell); the
port's ``mu_p_sweep.main`` then trains every (P, mu) cell from JAX's
initial params on JAX's batches and evaluation set, carried over as numpy
arrays. Per-step losses agree to rtol 1e-5 (XLA:CPU and ATen differ by a
few f32 ulps in tanh and the matmul sums), each accuracy within one of
the 2,048 evaluation examples, and the best mu per P is JAX's: P2=0.3,
P4=0.0, P8=0.5, P16=0.5. The assertion holds thinly: at P=16, mu 0.5
beats 0.3 by 9 examples.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.common import run_mlp as jrun_mlp  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common, mu_p_sweep  # noqa: E402

torch.set_num_threads(2)

STEPS = 40
EXPECTED_BEST = {2: 0.3, 4: 0.0, 8: 0.5, 16: 0.5}


def jax_inputs(steps):
    """``run_mlp`` overrides carrying JAX's own draws of one run: seed s
    init, fold_in(PRNGKey(s + 1), i) batches, the evaluation set."""
    ev = interop.params_from_jax(jax.device_get(
        classif_eval_set(common.D_IN, common.CLASSES)))

    def inputs(*, P, K, batch, seed):
        params = jax.device_get(mlp_init(jax.random.PRNGKey(seed),
                                         common.D_IN, common.HIDDEN,
                                         common.CLASSES))
        bf = classif_batch_fn(common.D_IN, common.CLASSES, P, K, batch)
        key = jax.random.PRNGKey(seed + 1)
        batches = [interop.params_from_jax(jax.device_get(
            bf(jax.random.fold_in(key, i), i))) for i in range(steps)]
        return dict(params=interop.params_from_jax(params),
                    batch_at=batches.__getitem__, eval_set=ev)

    return inputs


def test_settings_are_the_references():
    from benchmarks import mu_p_sweep as jsweep

    assert mu_p_sweep.MUS == jsweep.MUS and mu_p_sweep.PS == jsweep.PS
    assert (mu_p_sweep.K, mu_p_sweep.LR, mu_p_sweep.BATCH) == (4, 0.15, 8)


@pytest.fixture(scope="module")
def port_sweep():
    lines = []
    table, curves = mu_p_sweep.sweep(quick=True, device="cpu",
                                     inputs=jax_inputs(STEPS),
                                     log=lines.append)
    return table, curves, lines


@pytest.mark.parametrize("P", mu_p_sweep.PS)
def test_quick_sweep_fed_jax_inputs_matches_jax(port_sweep, P):
    table, curves, _ = port_sweep
    for mu in mu_p_sweep.MUS:
        jlosses, jacc = jrun_mlp("mavg", P=P, K=4, mu=mu, lr=0.15,
                                 steps=STEPS, batch=8, seed=0)
        (losses,) = curves[(P, mu)]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert abs(table[(P, mu)] - jacc) <= 1 / 2048 + 1e-9, (P, mu)
    assert mu_p_sweep.best_mu(table)[P] == EXPECTED_BEST[P]


def test_main_prints_and_asserts_the_references_verdict(port_sweep,
                                                        monkeypatch):
    table, curves, lines = port_sweep
    monkeypatch.setattr(mu_p_sweep, "sweep",
                        lambda *a, **k: (table, curves))
    out = []
    got, best = mu_p_sweep.main(quick=True, device="cpu", log=out.append)
    assert best == EXPECTED_BEST and got is table
    assert out == ["mu_p_sweep,best_mu_per_P,P2=0.3,P4=0.0,P8=0.5,P16=0.5"]
    assert lines[0].startswith("mu_p_sweep,P=2,mu=0.0,val_acc=")
    assert len(lines) == 20
    # a table whose best mu falls with P fails Lemma 6's assertion
    flipped = {(P, mu): (1.0 if (mu == 0.9) == (P == 2) else 0.5)
               for P in mu_p_sweep.PS for mu in mu_p_sweep.MUS}
    monkeypatch.setattr(mu_p_sweep, "sweep",
                        lambda *a, **k: (flipped, curves))
    with pytest.raises(AssertionError):
        mu_p_sweep.main(quick=True, device="cpu", log=out.append)
