"""E1's tiny-transformer case (quick mode) on the port, fed the JAX
runner's inputs.

``benchmarks/convergence.py::run_tiny_transformer``
(``qwen3-1.7b.reduced()``, bf16 activations as the config says, P=4,
K=2, B=8, sequences of 32, 15 meta steps), K-AVG and M-AVG, runs in JAX;
the port's ``run_tiny_transformer`` then trains from the same initial
params on the same bigram batches. Per-step losses and the final
perplexity agree to rtol 1e-3 (3.5e-4 at most, measured): the model
computes in bfloat16, and XLA:CPU and ATen round its matmuls and softmax
sums differently. The JAX runner takes about 18 s an arm on the CPU, so
this file checks K-AVG and ``test_torch_convergence_transformer_mavg.py``
checks M-AVG through ``check_arm`` here. The samples to the 5.5 target are JAX's:
896 for K-AVG and 640 for M-AVG.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.convergence import run_tiny_transformer as jrun_tt  # noqa: E402,E501
from repro.configs import get_config  # noqa: E402
from repro.data import lm_batch_fn  # noqa: E402
from repro.models import api  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common, convergence  # noqa: E402

torch.set_num_threads(2)

SETTINGS = dict(P=4, K=2, lr=0.5, steps=15)
B, SEQ = 8, 32
EXPECTED_STT = {"kavg": 896, "mavg": 640}


def test_quick_settings_are_the_references():
    model, runner, kw, target = convergence.cases(quick=True)[2]
    assert (model, runner, kw, target) == (
        "tiny-transformer", convergence.run_tiny_transformer, SETTINGS, 5.5)
    assert convergence.TT_SEQ == SEQ


def _jax_inputs():
    """The runner's own inputs: the seed-0 init and the
    fold_in(PRNGKey(1), i) batches."""
    cfg = get_config("qwen3-1.7b").reduced()
    params = jax.device_get(api.init_params(jax.random.PRNGKey(0), cfg))
    bf = lm_batch_fn(cfg, SETTINGS["P"], SETTINGS["K"], B, SEQ)
    batches = [jax.device_get(bf(jax.random.fold_in(jax.random.PRNGKey(1),
                                                    i), i))
               for i in range(SETTINGS["steps"])]
    return params, batches


def check_arm(algo, mu):
    P, K, steps = SETTINGS["P"], SETTINGS["K"], SETTINGS["steps"]
    jlosses, jppl = jrun_tt(algo, mu=mu, **SETTINGS)
    params, batches = _jax_inputs()
    losses, ppl = convergence.run_tiny_transformer(
        algo, mu=mu, **SETTINGS, device="cpu",
        params=interop.params_from_jax(params),
        batch_at=lambda i: interop.params_from_jax(batches[i]))
    assert len(losses) == len(jlosses) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(ppl, jppl, rtol=1e-3)
    stt = common.samples_to_target(losses, 5.5, P, K, B)
    assert stt == common.samples_to_target(jlosses, 5.5, P, K, B)
    assert stt == EXPECTED_STT[algo]


def test_tiny_transformer_kavg_fed_jax_inputs_matches_jax():
    check_arm(*convergence.ARMS[0])
