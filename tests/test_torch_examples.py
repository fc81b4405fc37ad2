"""The port's examples against the JAX package's, on the same inputs.

* ``train_100m`` at its small width (4 layers, d_model 256, V 4096; L=2,
  K=2, B=2, sequences of 32, 2 meta steps, the warmup-cosine schedule),
  in float32 compute: the port's Trainer fed the JAX Trainer's initial
  params and bigram batches. What the two meta updates did to the params,
  dtheta, agrees with JAX's to a relative norm of 5e-5 (measured 6.0e-6
  on the CPU: XLA:CPU and ATen sum the f32 gradients in other orders),
  and the logged losses and the evaluation loss to rtol 1e-5; the two
  updates move the logged loss by over 100 times that. The same check
  refuses a planted fault: a zero learning rate, no block momentum or
  half of each batch move dtheta by 1.0, 0.28 and 0.998 of its norm
  (the check asks for more than 1e-2). The parameter count of both
  widths is JAX's (the full width: 125,848,320).
* ``serve_batch`` on every dense ``.reduced()`` architecture (qwen3-1.7b,
  qwen2-7b, qwen1.5-110b, llama3-405b), from JAX's params and prompt: in
  float32 compute the 12 greedy tokens of each of the 2 sequences equal
  JAX's. In the configs' own bfloat16 the prefill's token equals JAX's;
  later tokens may part where two logits lie within bf16 rounding of each
  other (XLA:CPU and ATen round the matmuls differently), and one token
  apart feeds a different history from then on. The MoE archs
  (deepseek-moe-16b, kimi-k2-1t-a32b) are held the same way, and
  internvl2's decode-only demo from an empty cache gives JAX's tokens in
  float32. hubert is skipped as encoder-only; the hybrid and SSM archs
  (hymba-1.5b, xlstm-350m) are served and held as the dense ones.
* ``momentum_tuning``: both guidelines, fed JAX's ``run_mlp`` draws, give
  JAX's accuracies within one of 2,048 evaluation examples.
"""
import dataclasses
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import run_mlp as jrun_mlp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.trainer import Trainer as JTrainer  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.data import lm_batch_fn, lm_eval_set  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro.optim import warmup_cosine  # noqa: E402
from repro.pack import unpack_params as junpack  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.examples import momentum_tuning, serve_batch  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.pack import unpack_params  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ("llama3-405b", "qwen3-1.7b", "qwen1.5-110b", "qwen2-7b")
MOE = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
HYBRID_SSM = ("hymba-1.5b", "xlstm-350m")


def _reference(name):
    """The JAX package's example module ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# train_100m
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["small", "full"])
def test_train_100m_configs_are_the_references(width):
    jcfg = _reference("train_100m").make_config(width)
    cfg = train_100m.make_config(width)
    assert {f: getattr(cfg, f) for f in jcfg.__dataclass_fields__} == {
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    n = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
        lambda k: japi.init_params(k, jcfg), jax.random.PRNGKey(0))))
    assert train_100m.param_count(cfg) == n
    if width == "full":
        assert n == 125_848_320


# dtheta of the port against JAX's, relative to JAX's norm
DTHETA_RTOL = 5e-5


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in tree])


@pytest.fixture(scope="module")
def jax_100m():
    """The JAX Trainer on the small width in float32, 2 meta steps: its
    history, eval loss, initial params, dtheta and the inputs it drew."""
    cfg = dataclasses.replace(_reference("train_100m").make_config("small"),
                              dtype="float32")
    args = train_100m.parser().parse_args([])
    mcfg = JMAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                       learner_lr=args.lr, momentum=args.momentum)
    tcfg = JTrainConfig(model=cfg, mavg=mcfg, batch_per_learner=2,
                        seq_len=32, meta_steps=2, log_every=10)
    bf = lm_batch_fn(cfg, 2, 2, 2, 32)
    jtr = JTrainer(tcfg, lambda p, b: japi.loss_fn(p, cfg, b),
                   init_params_fn=lambda rng: japi.init_params(rng, cfg),
                   batch_fn=bf, lr_schedule=warmup_cosine(args.lr, 20, 2))
    theta0 = jax.device_get(junpack(jtr.state))  # the state is donated
    jparams = jax.device_get(japi.init_params(
        jax.random.split(jax.random.PRNGKey(0))[1], cfg))
    for a, b in zip(jax.tree.leaves(theta0), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    jhist = jtr.run(log=None)
    ev = jax.device_get(lm_eval_set(cfg, n=32, seq_len=32))
    theta = junpack(jtr.state)
    jloss = float(japi.loss_fn(theta, cfg, ev)[0])
    dtheta = (_flat(jax.tree.leaves(jax.device_get(theta)))
              - _flat(jax.tree.leaves(theta0)))
    batches = [interop.params_from_jax(jax.device_get(
        bf(jax.random.fold_in(jtr.data_rng, s), s))) for s in range(2)]
    return SimpleNamespace(cfg=cfg, hist=jhist, loss=jloss, dtheta=dtheta,
                           params=interop.params_from_jax(jparams),
                           batches=batches,
                           eval_set=interop.params_from_jax(ev))


def _port_100m(ref, argv=(), batch_at=None):
    """The port's example on JAX's inputs: (history, eval loss, dtheta,
    logged lines, trainer)."""
    args = train_100m.parser().parse_args(
        ["--steps", "2", "--learners", "2", "--k", "2", "--batch", "2",
         "--seq", "32", "--device", "cpu", *argv])
    lines = []
    trainer, hist, loss, _ = train_100m.run(
        args, params=ref.params,
        batch_at=batch_at or ref.batches.__getitem__,
        eval_set=ref.eval_set, log=lines.append,
        cfg=dataclasses.replace(train_100m.make_config("small"),
                                dtype="float32"))
    dtheta = (_flat(x.numpy() for x in tree_leaves(
        unpack_params(trainer.state)))
        - _flat(x.numpy() for x in tree_leaves(ref.params)))
    return hist, loss, dtheta, lines, trainer


def _dtheta_err(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_train_100m_small_width_fed_jax_inputs_matches_jax(jax_100m):
    ref = jax_100m
    hist, loss, dtheta, lines, trainer = _port_100m(ref)
    assert [r["meta_step"] for r in hist] == [r["meta_step"] for r in ref.hist]
    # the two updates move the logged loss far beyond the tolerance below
    assert ref.hist[0]["loss"] - ref.hist[-1]["loss"] > 100 * 1e-5 * loss
    assert _dtheta_err(dtheta, ref.dtheta) <= DTHETA_RTOL
    np.testing.assert_allclose([r["loss"] for r in hist],
                               [r["loss"] for r in ref.hist], rtol=1e-5)
    np.testing.assert_allclose(loss, ref.loss, rtol=1e-5)
    assert hist[-1]["samples"] == ref.hist[-1]["samples"] == 16
    assert lines[0] == ("model: dense-8m (6.0M params, 6,031,616), P=2 K=2 "
                        "B=2 seq=32")
    assert lines[-1].startswith("\ndone: train loss ")
    assert all(bool(torch.isfinite(p).all()) for p in (
        trainer.state.global_params, trainer.state.momentum,
        trainer.state.learners))


@pytest.mark.parametrize("fault", ["lr0", "mu0", "half_batch"])
def test_train_100m_parity_check_refuses_a_planted_fault(jax_100m, fault):
    ref = jax_100m
    argv, batch_at = {
        "lr0": (["--lr", "0"], None),
        "mu0": (["--momentum", "0"], None),
        "half_batch": ((), lambda s: {k: v[:, :, :1] for k, v in
                                      ref.batches[s].items()}),
    }[fault]
    _, _, dtheta, _, _ = _port_100m(ref, argv, batch_at)
    assert _dtheta_err(dtheta, ref.dtheta) > 1e-2


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

def _jax_greedy(arch, dtype, batch=2, prompt_len=8, new_tokens=12):
    """The reference example's loop in ``dtype`` compute, returning its
    tokens and inputs."""
    cfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (batch, prompt_len),
                                0, cfg.vocab_size, jnp.int32)
    cache_len = prompt_len + new_tokens + 8
    logits, cache = jax.jit(lambda p, b: japi.prefill(p, cfg, b, cache_len))(
        params, {"tokens": prompt})
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, cfg, c, t))
    toks = []
    for _ in range(new_tokens):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(nxt)
        logits, cache = decode(params, cache, nxt)
    return (np.stack(jax.device_get(toks), 1), jax.device_get(params),
            np.array(prompt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID_SSM)
def test_serve_batch_greedy_tokens_equal_jax(monkeypatch, arch, dtype):
    want, params, prompt = _jax_greedy(arch, dtype)
    reduced = dataclasses.replace(tget_config(arch).reduced(), dtype=dtype)
    monkeypatch.setattr(serve_batch, "get_config", lambda a: SimpleNamespace(
        reduced=lambda: reduced))
    lines = []
    got = serve_batch.serve(arch, 2, 8, 12, device="cpu",
                            params=interop.params_from_jax(params),
                            prompt=torch.from_numpy(prompt), log=lines.append)
    assert got.shape == (2, 12) and got.dtype == torch.int32
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy()[:, 0], want[:, 0])
    assert lines[0].startswith(f"{arch}: 2 seqs x 12 tokens in ")
    # the position counts Hymba's meta tokens
    assert lines[0].endswith(f"cache pos {20 + reduced.meta_tokens}")


def test_serve_batch_vlm_decode_only_demo_equals_jax(monkeypatch):
    """internvl2: the reference's demo decodes from an empty cache and
    zero logits; in float32 its 12 greedy tokens equal JAX's."""
    arch = "internvl2-76b"
    cfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    cache = japi.init_cache(cfg, 2, 28)
    logits = jnp.zeros((2, cfg.vocab_size))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, cfg, c, t))
    want = []
    for _ in range(12):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(nxt)
        logits, cache = decode(params, cache, nxt)
    reduced = dataclasses.replace(tget_config(arch).reduced(),
                                  dtype="float32")
    monkeypatch.setattr(serve_batch, "get_config", lambda a: SimpleNamespace(
        reduced=lambda: reduced))
    lines = []
    got = serve_batch.serve(arch, 2, 8, 12, device="cpu",
                            params=interop.params_from_jax(
                                jax.device_get(params)), log=lines.append)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack(jax.device_get(want), 1))
    assert lines[0] == f"{arch}: stub-frontend input; decode-only demo"
    assert lines[1].endswith("cache pos 12")


def test_serve_batch_names_item_9_for_every_other_family(capsys):
    """The reference's branches: every decode-capable arch served (the
    hybrid and SSM ones too: no family names ROADMAP Queue 1, item 9 any
    more), hubert skipped as encoder-only, internvl2's decode-only
    demo."""
    out = serve_batch.main(["--device", "cpu", "--tokens", "2"])
    assert list(out) == ARCH_IDS
    text = capsys.readouterr().out
    for arch, toks in out.items():
        if arch == "hubert-xlarge":
            assert toks is None
            assert f"{arch}: encoder-only, no decode (skipped)" in text
        else:
            assert toks.shape == (2, 2)
            assert f"{arch}: 2 seqs x 2 tokens in " in text
    for arch in ("hymba-1.5b", "xlstm-350m"):
        assert out[arch].dtype == torch.int32
    assert "internvl2-76b: stub-frontend input; decode-only demo" in text
    assert "ROADMAP" not in text


# ---------------------------------------------------------------------------
# momentum_tuning
# ---------------------------------------------------------------------------

def test_momentum_tuning_fed_jax_inputs_matches_jax(capsys):
    seen = []

    def inputs(*, P, K, batch, seed):
        steps = 60 if K == 4 else 128 // K
        params = jax.device_get(mlp_init(jax.random.PRNGKey(seed), 32, 64,
                                         10))
        bf = classif_batch_fn(32, 10, P, K, batch)
        key = jax.random.PRNGKey(seed + 1)
        batches = [interop.params_from_jax(jax.device_get(
            bf(jax.random.fold_in(key, i), i))) for i in range(steps)]
        ev = jax.device_get(classif_eval_set(32, 10))
        seen.append((P, K, steps))
        return dict(params=interop.params_from_jax(params),
                    batch_at=batches.__getitem__,
                    eval_set=interop.params_from_jax(ev))

    best1, best2 = momentum_tuning.main(["--device", "cpu"], inputs=inputs)
    text = capsys.readouterr().out
    accs = [float(ln.rsplit("=", 1)[1]) for ln in text.splitlines()
            if "val_acc=" in ln]
    runs = ([(P, 4, mu, 60) for P in (2, 8) for mu in (0.0, 0.5, 0.9)]
            + [(4, K, mu, 128 // K) for mu in (0.0, 0.7) for K in (2, 8)])
    assert [(P, K, s) for P, K, _, s in runs] == seen
    for acc, (P, K, mu, steps) in zip(accs, runs):
        _, jacc = jrun_mlp("mavg", P=P, K=K, mu=mu, steps=steps, batch=8)
        assert abs(acc - jacc) <= 0.001 + 1e-9, (P, K, mu)  # printed %.3f
    assert set(best1) == {2, 8} and set(best2) == {0.0, 0.7}
    assert "Guideline 1 (Lemma 6)" in text and "Guideline 2 (Lemma 7)" in text
