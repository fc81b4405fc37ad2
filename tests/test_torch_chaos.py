"""The port's fault injection (``repro_torch.chaos``) and in-step finite
guard against the JAX package's ``repro.chaos`` and ``core.meta``.

Tolerances, with their reasons:

* ``FaultSchedule``: EXACTLY equal arrays (the same numpy code, the same
  ``RandomState`` draws);
* ``PayloadCorruptor`` and ``wrap_batch_fn`` on the same inputs: BITWISE
  equal (one f32 multiply per value, rounded to the plane's dtype, and
  one XOR; NaN/Inf written as such);
* ``_finite_guard`` on the same learners: BITWISE (a select, or a reset
  to gp in the learner dtype);
* meta steps on the MLP: rtol 1e-5 / atol 1e-6 (the local phase differs
  by a few ulps between XLA:CPU and ATen); injectors off against no chaos
  at all, inside the port: BITWISE.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.chaos import ChaosConfig as JChaosConfig  # noqa: E402
from repro.chaos import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.chaos import FaultSpec as JFaultSpec  # noqa: E402
from repro.chaos import PayloadCorruptor as JPayloadCorruptor  # noqa: E402
from repro.chaos import apply_chaos as japply_chaos  # noqa: E402
from repro.chaos import standard_chaos as jstandard_chaos  # noqa: E402
from repro.chaos import wrap_batch_fn as jwrap_batch_fn  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import meta as jmeta  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    ChaosConfig,
    FaultSchedule,
    FaultSpec,
    PayloadCorruptor,
    apply_chaos,
    standard_chaos,
    wrap_batch_fn,
)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import meta  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.topology import make_topology  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

L, K, B, D, C, H = 2, 2, 4, 8, 4, 16
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))
SCHEDULE_ARRAYS = ("nan", "inf", "scale", "xor", "pos", "crash",
                   "straggle_extra")


def _faults(pkg, faults):
    FS = JFaultSpec if pkg == "jax" else FaultSpec
    return tuple(FS(**f) for f in faults)


def _chaos(pkg, faults, horizon=8, seed=0):
    CC = JChaosConfig if pkg == "jax" else ChaosConfig
    return CC(seed=seed, horizon=horizon, faults=_faults(pkg, faults))


def _batches(seed, n=L):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (n, K, B)).astype(np.int32)}


def _pair(**kw):
    def make(base):
        k = dict(kw)
        if "topology" in k:
            t = dict(k["topology"])
            if "elastic" in t:
                t["elastic"] = base.ElasticConfig(**t["elastic"])
            k["topology"] = base.TopologyConfig(**t)
        return base.MAvgConfig(**k)

    return make(jbase), make(tbase)


def _run_port(cfg, batch_list, chaos=None):
    topology = make_topology(cfg)
    state = meta.init_state(interop.params_from_jax(JPARAMS), cfg,
                            topology=topology)
    step = meta.make_meta_step(mlp_loss, cfg, topology=topology,
                               chaos=chaos)
    metrics = []
    for b in batch_list:
        state, m = step(state, interop.params_from_jax(b))
        metrics.append(m)
    return state, metrics


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# FaultSchedule: the same arrays as JAX's
# ---------------------------------------------------------------------------

MIXED = (
    dict(kind="nan_batch", step=1, learner=0, duration=2),
    dict(kind="inf_batch", step=2, learner=-1),
    dict(kind="payload_scale", step=3, learner=1, magnitude=3.0),
    dict(kind="payload_bitflip", step=4, learner=-1, bit=23, sticky=True),
    dict(kind="finite_scale", step=5, learner=2, duration=2,
         magnitude=12.0, sticky=True),
    dict(kind="finite_bitflip", step=0, learner=3, duration=8, bit=31),
    dict(kind="crash", step=2, learner=0, duration=3),
    dict(kind="straggle", step=0, learner=1, magnitude=2.0),
    dict(kind="torn_save", step=6),
    dict(kind="corrupt_save", step=7),
)


@pytest.mark.parametrize("salt", [0, 1])
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_schedule_arrays_equal_jax(seed, salt):
    for num_learners in (4, 8):
        got = FaultSchedule(_chaos("port", MIXED, seed=seed), num_learners,
                            salt=salt)
        want = JFaultSchedule(_chaos("jax", MIXED, seed=seed), num_learners,
                              salt=salt)
        for name in SCHEDULE_ARRAYS:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.save_faults == want.save_faults
        for step in range(-1, 10):
            for x, y in zip(got.batch_fault_at(step),
                            want.batch_fault_at(step)):
                np.testing.assert_array_equal(x, y)
            assert got.suspect(step) == want.suspect(step)
        assert (got.any_batch_faults, got.any_payload_faults,
                got.any_crash_faults) == (
            want.any_batch_faults, want.any_payload_faults,
            want.any_crash_faults)


@pytest.mark.parametrize("steps,learners,seed", [(8, 2, 0), (32, 4, 7),
                                                 (16, 8, 3)])
def test_standard_chaos_equals_jax(steps, learners, seed):
    got = standard_chaos(learners, steps, seed=seed)
    want = jstandard_chaos(learners, steps, seed=seed)
    assert got.seed == want.seed and got.horizon == want.horizon
    assert [vars(f) for f in got.faults] == [vars(f) for f in want.faults]
    sub = standard_chaos(learners, steps, kinds=("crash", "payload"))
    assert {f.kind for f in sub.faults} == {"crash", "payload_scale",
                                            "payload_bitflip"}


# ---------------------------------------------------------------------------
# the injectors against JAX's, on the same inputs
# ---------------------------------------------------------------------------

PAYLOAD = (
    dict(kind="payload_scale", step=1, learner=1, magnitude=3.0),
    dict(kind="payload_bitflip", step=2, learner=0, bit=30),
    dict(kind="finite_bitflip", step=2, learner=2, bit=29),
    dict(kind="finite_scale", step=3, learner=2, magnitude=12.0,
         duration=2),
    dict(kind="payload_bitflip", step=3, learner=2, bit=31),
)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "tree"])
def test_payload_corruptor_matches_jax(layout, dtype):
    rng = np.random.default_rng(3)
    if layout == "packed":
        stack = {"p": rng.standard_normal((3, 16, 128))}
    else:  # the first float leaf (sorted keys) takes the bit-flip
        stack = {"b": rng.standard_normal((3, 7)),
                 "w": rng.standard_normal((3, 5, 9))}
    stack = {k: v.astype(np.float32) for k, v in stack.items()}
    jcor = JPayloadCorruptor(JFaultSchedule(_chaos("jax", PAYLOAD), 3))
    cor = PayloadCorruptor(FaultSchedule(_chaos("port", PAYLOAD), 3))
    assert cor.active and jcor.active
    for step in range(10):  # past the horizon too: quiet
        jx = {k: jnp.asarray(v, dtype) for k, v in stack.items()}
        tx = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in stack.items()}
        before = {k: v.clone() for k, v in tx.items()}
        want = jcor(jx, jnp.int32(step))
        got = cor(tx, step)
        for k in stack:
            w = np.asarray(want[k], np.float32)
            g = got[k].to(torch.float32).numpy()
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32))
        if step in (0,) or step >= 5:
            _bitwise(got, before)  # quiet steps write nothing


def test_wrap_batch_fn_matches_jax():
    faults = (dict(kind="nan_batch", step=1, learner=0),
              dict(kind="inf_batch", step=2, learner=1, duration=2))
    base = _batches(0)
    jwrapped = jwrap_batch_fn(lambda rng, s: base,
                              JFaultSchedule(_chaos("jax", faults), L))
    wrapped = wrap_batch_fn(lambda gen, s: interop.params_from_jax(base),
                            FaultSchedule(_chaos("port", faults), L))
    for step in range(5):
        want, got = jwrapped(None, step), wrapped(None, step)
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["y"].numpy(), want["y"])
    assert np.isnan(wrapped(None, 1)["x"][0].numpy()).all()
    assert np.isinf(wrapped(None, 3)["x"][1].numpy()).all()
    quiet = FaultSchedule(_chaos("port", ()), L)
    fn = (lambda gen, s: None)
    assert wrap_batch_fn(fn, quiet) is fn


# ---------------------------------------------------------------------------
# every injector off == vanilla, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_injectors_off_bitwise_identical(packed):
    """An idle corruptor installed and the finite guard on reproduce the
    plain run bit for bit, and apply_chaos without structural faults
    returns the config object itself."""
    empty = FaultSchedule(ChaosConfig(seed=0, horizon=8, faults=()), L)
    assert not (empty.any_batch_faults or empty.any_payload_faults
                or empty.any_crash_faults)
    kw = dict(algorithm="mavg", num_learners=L, k_steps=K, learner_lr=0.1,
              momentum=0.6, packed=packed)
    batch_list = [_batches(i) for i in range(3)]
    plain, _ = _run_port(tbase.MAvgConfig(**kw), batch_list)
    armed, m = _run_port(tbase.MAvgConfig(**kw, finite_guard=True),
                         batch_list, chaos=PayloadCorruptor(empty))
    for name in ("global_params", "momentum", "learners"):
        _bitwise(getattr(plain, name), getattr(armed, name))
    assert float(m[-1]["nonfinite_learners"]) == 0.0
    mcfg = tbase.MAvgConfig(**kw)
    chaos = ChaosConfig(seed=0, horizon=8, faults=(
        FaultSpec("nan_batch", step=1, learner=0),))
    assert apply_chaos(mcfg, chaos) is mcfg


# ---------------------------------------------------------------------------
# the finite guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlocal", [False, True], ids=["mavg", "mlocal"])
def test_finite_guard_matches_jax(mlocal):
    """A NaN in one learner's plane and an Inf in another's local
    momentum: both reset to gp (momentum zeroed), the rest untouched."""
    rng = np.random.default_rng(1)
    lrn = rng.standard_normal((4, 16, 128)).astype(np.float32)
    gp = rng.standard_normal((16, 128)).astype(np.float32)
    lrn[1, 3, 7] = np.nan
    mom = None
    if mlocal:
        mom = rng.standard_normal((4, 16, 128)).astype(np.float32)
        mom[2, 0, 0] = np.inf
    jl, jm, jmet = jmeta._finite_guard(
        jnp.asarray(lrn), None if mom is None else jnp.asarray(mom),
        jnp.asarray(gp), {}, 4)
    tl, tm, tmet = meta._finite_guard(
        torch.from_numpy(lrn.copy()),
        None if mom is None else torch.from_numpy(mom.copy()),
        torch.from_numpy(gp), {}, 4)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert float(tmet["nonfinite_learners"]) == float(
        jmet["nonfinite_learners"]) == (2.0 if mlocal else 1.0)
    np.testing.assert_array_equal(tl[1].numpy(), gp)
    np.testing.assert_array_equal(tl[0].numpy(), lrn[0])
    if mlocal:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert not tm[2].any() and torch.isfinite(tm).all()


def test_nan_batch_guard_keeps_state_finite_as_jax():
    """A poisoned batch NaNs learner 0's local phase; the guard resets
    it, reports it, and the state matches JAX's after the step."""
    faults = (dict(kind="nan_batch", step=0, learner=0),)
    jcfg, cfg = _pair(algorithm="mavg", num_learners=L, k_steps=K,
                      learner_lr=0.1, momentum=0.6, finite_guard=True)
    base = _batches(0)
    jb = jwrap_batch_fn(lambda r, s: base,
                        JFaultSchedule(_chaos("jax", faults, 4), L))(None, 0)
    b = wrap_batch_fn(lambda g, s: interop.params_from_jax(base),
                      FaultSchedule(_chaos("port", faults, 4), L))(None, 0)
    js, jm = jax.jit(jmeta.make_meta_step(jmlp_loss, jcfg))(
        jmeta.init_state(JPARAMS, jcfg), jb)
    topology = make_topology(cfg)
    state = meta.init_state(interop.params_from_jax(JPARAMS), cfg,
                            topology=topology)
    state, m = meta.make_meta_step(mlp_loss, cfg, topology=topology)(
        state, b)
    assert float(m["nonfinite_learners"]) == float(
        jm["nonfinite_learners"]) == 1.0
    for x in (state.global_params, state.momentum, state.learners):
        assert bool(torch.isfinite(x).all())
    for name in ("global_params", "momentum", "learners"):
        np.testing.assert_allclose(
            getattr(state, name).numpy(),
            np.asarray(jax.device_get(getattr(js, name))), rtol=1e-5,
            atol=1e-6)


# ---------------------------------------------------------------------------
# apply_chaos: crash windows -> membership; unported kinds raise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", [
    dict(kind="gossip", graph="ring"),
    dict(kind="hierarchical", groups=2,
         elastic=dict(period=3, drop_frac=0.25, seed=1)),
], ids=["gossip", "hier_elastic"])
def test_apply_chaos_crash_to_membership_as_jax(topo):
    faults = (dict(kind="crash", step=1, learner=2, duration=2),)
    jcfg, cfg = _pair(algorithm="mavg", num_learners=4, k_steps=K,
                      topology=topo)
    for salt in (0, 1):
        want = japply_chaos(jcfg, _chaos("jax", faults, 6), salt=salt)
        got = apply_chaos(cfg, _chaos("port", faults, 6), salt=salt)
        assert got.topology.elastic.schedule == \
            want.topology.elastic.schedule
        assert got.topology.elastic.period == want.topology.elastic.period
    rows = np.asarray(got.topology.elastic.schedule)
    assert rows.shape == (6, 4)
    with pytest.raises(ValueError, match="flat"):
        apply_chaos(tbase.MAvgConfig(num_learners=4),
                    _chaos("port", faults, 6))


def test_crash_run_follows_the_membership():
    """A gossip run with learner 2 crashed on steps 1-2: 3 of 4 learners
    present there, its params frozen, and the run finite."""
    faults = (dict(kind="crash", step=1, learner=2, duration=2),)
    _, cfg = _pair(algorithm="mavg", num_learners=4, k_steps=K,
                   learner_lr=0.1, momentum=0.6,
                   topology=dict(kind="gossip", graph="ring"))
    cfg = apply_chaos(cfg, _chaos("port", faults, 4))
    state, m = _run_port(cfg, [_batches(i, 4) for i in range(4)])
    assert [x["present_count"] for x in m] == [4.0, 3.0, 3.0, 4.0]
    assert bool(torch.isfinite(state.global_params).all())


def test_unported_faults_raise():
    mcfg = tbase.MAvgConfig(num_learners=2, k_steps=K)
    straggle = ChaosConfig(seed=0, horizon=8, faults=(
        FaultSpec("straggle", step=0, learner=1, magnitude=3.0),))
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        apply_chaos(mcfg, straggle)
    torn = ChaosConfig(seed=0, horizon=8, faults=(
        FaultSpec("torn_save", step=2),))
    tcfg = tbase.TrainConfig(model=None, mavg=mcfg, batch_per_learner=B,
                             meta_steps=2, chaos=torn)
    # save faults are ported now (the checkpoint chain): the Trainer takes
    # them, and tests/test_torch_checkpoint.py resumes past one
    trainer = Trainer(tcfg, mlp_loss,
                      init_params_fn=lambda g: interop.params_from_jax(
                          JPARAMS),
                      batch_fn=lambda g, s: None, device="cpu")
    assert trainer._chaos_schedule.save_fault(2) == "torn"
    # the supervisor is ported now: --supervise is refused only without
    # the checkpoint chain it rolls back through, with JAX's message
    with pytest.raises(SystemExit, match="--supervise needs --checkpoint-dir"):
        launch_train.main(["--device", "cpu", "--supervise"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        launch_train.main(["--device", "cpu", "--chaos", "--steps", "8",
                           "--chaos-faults", "straggle"])


def test_launcher_runs_robust_and_chaos_on_cpu(capsys):
    launch_train.main(["--device", "cpu", "--learners", "4", "--k", "2",
                       "--steps", "8", "--batch", "2", "--seq", "16",
                       "--topology", "gossip", "--robust", "trimmed",
                       "--robust-clip", "3", "--robust-clip-window", "2",
                       "--finite-guard", "--chaos", "--chaos-faults",
                       "crash,payload"])
    out = capsys.readouterr().out
    assert "meta_step=7" in out and "eval loss" in out
    assert "robust clipped" in out and "nonfinite_learners 0" in out
