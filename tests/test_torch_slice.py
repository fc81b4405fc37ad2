"""The slice as a whole: the port's Trainer against the JAX meta step on
``qwen3-1.7b.reduced()`` with ``dtype="float32"``, mavg, L=2, K=2, B=2,
S=16, lr 0.1, 2 meta steps, from carried-over JAX params and JAX-made
bigram batches. Per-step loss and the final ``global_params`` agree to
rtol=1e-5, atol=1e-6 (f32 matmul/softmax sums in another order in XLA:CPU
and ATen, compounded over 4 local steps per learner).

Also the slice's entry points on the CPU: the learning-rate schedules
against JAX's float32 values, and the launcher end to end.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import lm_batch_fn as jlm_batch_fn  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import MAvgConfig, TrainConfig  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402

torch.set_num_threads(2)

L, K, B, S, STEPS = 2, 2, 2, 16, 2
MAVG = dict(algorithm="mavg", num_learners=L, k_steps=K, learner_lr=0.1,
            momentum=0.7)


def test_trainer_matches_jax_meta_steps():
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    make_batches = jlm_batch_fn(jcfg, L, K, B, S)
    batches = [jax.device_get(make_batches(jax.random.PRNGKey(10 + i), i))
               for i in range(STEPS)]

    mcfg = JMAvgConfig(**MAVG, use_pallas=True)
    state = jinit_state(params, mcfg)
    step = jax.jit(jmake_meta_step(lambda p, b: japi.loss_fn(p, jcfg, b),
                                   mcfg))
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    ref = np.asarray(state.global_params)

    trainer = Trainer(
        TrainConfig(model=tcfg, mavg=MAvgConfig(**MAVG),
                    batch_per_learner=B, seq_len=S, meta_steps=STEPS),
        lambda p, b: api.loss_fn(p, tcfg, b),
        init_params_fn=lambda gen: interop.params_from_jax(params),
        batch_fn=lambda gen, i: interop.params_from_jax(batches[i]),
        device="cpu",
    )
    history = trainer.run(log=None)
    assert [h["meta_step"] for h in history] == list(range(STEPS))
    np.testing.assert_allclose([h["loss"] for h in history], losses,
                               rtol=1e-5, atol=1e-6)
    got = trainer.state.global_params
    assert tuple(got.shape) == ref.shape == (10_256, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    last = history[-1]
    assert last["samples"] == STEPS * L * K * B
    assert last["meta_steps_per_sec"] > 0 and np.isfinite(last["v_norm"])


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (0.3, 5, 30)),
    ("warmup_cosine", (0.01, 5, 3)),
    ("cosine", (0.1, 17)),
    ("constant", (0.3,)),
])
def test_schedules_give_jax_float32(name, args):
    """The lr that reaches the kernel is the float32 JAX computes, up to
    XLA's float32 cosine: it is not always correctly rounded, the port's
    is, and a 1-ulp cosine difference moves the lr by at most 2 ulps.
    Warmup and constant steps match exactly."""
    ours, theirs = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    for step in range(40):
        a, b = ours(step), np.float32(theirs(step))
        assert isinstance(a, np.float32)
        ulps = abs(int(a.view(np.int32)) - int(b.view(np.int32)))
        exact = name == "constant" or (name == "warmup_cosine"
                                       and step < args[1])
        assert ulps == 0 if exact else ulps <= 2, (step, a, b)


def test_launcher_runs_on_cpu(capsys):
    launch_train.main(["--device", "cpu", "--learners", "2", "--k", "2",
                       "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "meta_step=1" in out and "eval loss" in out


def test_launcher_runs_compressed_on_cpu(capsys):
    """One reduced meta step with int8 + error feedback on the CPU."""
    launch_train.main(["--device", "cpu", "--learners", "2", "--k", "2",
                       "--steps", "1", "--batch", "2", "--seq", "16",
                       "--comm", "int8"])
    out = capsys.readouterr().out
    assert "meta_step=0" in out and "comm_compression 3.9" in out
