"""The port's checkpoint (``repro_torch.checkpoint``) against the JAX
package's ``checkpoint/npz.py``.

Part 1 mirrors ``tests/test_checkpoint.py`` on the port: the
bit-identical round trip and resume (the async server's clocks, stamps
and anchors halted mid-window too), the momentum and error-feedback residual, the verified chain
(torn, corrupt, truncated, entry-set mismatch, non-finite, torn sidecar),
retention and pruning; and the retry helper as ``tests/test_chaos.py``
pins it.

Part 2 is the two packages on each other's files. JAX trains 2 meta
steps and saves; the port loads the file into its own fresh state (in
place), and every plane and ``step`` is bitwise JAX's. The port saves that
state and JAX loads it back, bitwise again; each package's
``verify_checkpoint`` accepts the other's file, and the two sidecars are
the same JSON (the same entries, CRCs, shapes, dtypes and npz size).
Covered: flat dense packed and per-leaf, int8 + error feedback packed and
per-leaf, learner-level momentum, gossip with its residual, hierarchical
with elastic membership and an int8 + EF inner level, the async server
(its int32 clocks on the host, its anchor stack; halted mid-window,
packed and, with elastic membership, per-leaf), the robust clip's host
ring, and bf16 learner planes. JAX cannot load a bf16 plane at all,
not even from its own file (numpy has no cast from the ``|V2`` words the
plane becomes), so for bf16 the port's file is checked word for word
against JAX's instead and JAX's failure is pinned.

Part 3: a legacy per-leaf JAX checkpoint restored into a packed port
template, a bitwise resume of the port's Trainer on the CPU, the
launcher's ``--checkpoint-dir ... --resume`` (and JAX loading the
launcher's file), and a chaos ``torn_save`` run resumed from the last
verified snapshot.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointVerifyError as JCheckpointVerifyError  # noqa: E402,E501
from repro.checkpoint import load_state as jload_state  # noqa: E402
from repro.checkpoint import save_state as jsave_state  # noqa: E402
from repro.checkpoint import verify_checkpoint as jverify  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.utils import retry as jretry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.chaos import ChaosConfig, FaultSpec  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointVerifyError,
    checkpoint_step,
    latest_checkpoint,
    latest_verified_checkpoint,
    load_packspec,
    load_state,
    prune_checkpoints,
    save_state,
    verified_checkpoints,
    verify_checkpoint,
)
from repro_torch.checkpoint import npz as npz_mod  # noqa: E402
from repro_torch.checkpoint.npz import CRC_SUFFIX  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.utils import retry  # noqa: E402
from repro_torch.utils.rng import seeded_generator  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

D, H, C = 8, 16, 4


def _batches(seed, L=2, K=2, B=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((L, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (L, K, B)).astype(np.int32)}


def _tb(seed, **kw):
    return interop.params_from_jax(_batches(seed, **kw))


def _params(seed=0):
    return mlp_init(seeded_generator("cpu", seed), D, H, C, device="cpu")


def _cfg(**kw):
    kw = dict(dict(algorithm="mavg", num_learners=2, k_steps=2,
                   learner_lr=0.1, momentum=0.6), **kw)
    return tbase.MAvgConfig(**kw)


def _planes(state):
    """Every tensor of a state, in checkpoint order, with its key."""
    return [(k, v) for k, v in npz_mod._entries(state)
            if isinstance(v, torch.Tensor)]


def _assert_states_equal(a, b):
    assert a.step == b.step
    pa, pb = _planes(a), _planes(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


# ---------------------------------------------------------------------------
# part 1: tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------


def test_roundtrip_bit_identical(tmp_path):
    cfg = _cfg()
    step = make_meta_step(mlp_loss, cfg)
    state = init_state(_params(), cfg)
    for i in range(3):
        state, _ = step(state, _tb(i))
    path = save_state(str(tmp_path), state, 3)
    assert latest_checkpoint(str(tmp_path)) == path

    restored = load_state(path, init_state(_params(1), cfg))
    assert restored.step == 3
    live = state
    for i in range(3, 5):
        live, _ = step(live, _tb(i))
        restored, _ = step(restored, _tb(i))
    _assert_states_equal(live, restored)


def test_restore_is_in_place(tmp_path):
    """load_state copies into the template's own planes and allocates no
    second state."""
    cfg = _cfg()
    state, _ = make_meta_step(mlp_loss, cfg)(init_state(_params(), cfg),
                                             _tb(0))
    path = save_state(str(tmp_path), state, 1)
    template = init_state(_params(1), cfg)
    ptrs = [v.data_ptr() for _, v in _planes(template)]
    restored = load_state(path, template)
    assert [v.data_ptr() for _, v in _planes(restored)] == ptrs
    assert restored.global_params is template.global_params
    _assert_states_equal(state, restored)


def test_refused_checkpoint_leaves_template_untouched(tmp_path):
    """Entries are checked before the first copy: a checkpoint of another
    learner count is refused with the template as it was."""
    path = save_state(str(tmp_path), init_state(_params(), _cfg()), 1)
    template = init_state(_params(1), _cfg(num_learners=3))
    before = [v.clone() for _, v in _planes(template)]
    with pytest.raises(ValueError, match="shape"):
        load_state(path, template)
    for (k, v), w in zip(_planes(template), before):
        assert torch.equal(v, w), k


def test_momentum_saved(tmp_path):
    cfg = _cfg(k_steps=1, learner_lr=0.2, momentum=0.9)
    state, _ = make_meta_step(mlp_loss, cfg)(init_state(_params(1), cfg),
                                             _tb(0, K=1))
    assert float(state.momentum.abs().sum()) > 0
    path = save_state(str(tmp_path), state, 1)
    restored = load_state(path, init_state(_params(2), cfg))
    assert torch.equal(restored.momentum, state.momentum)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per-leaf"])
def test_comm_residual_roundtrip(tmp_path, packed):
    cfg = _cfg(packed=packed, comm=tbase.CommConfig(scheme="int8",
                                                    error_feedback=True))
    step = make_meta_step(mlp_loss, cfg)
    state = init_state(_params(2), cfg)
    for i in range(3):
        state, _ = step(state, _tb(i))
    assert state.comm_residual is not None
    assert sum(float(x.abs().sum())
               for x in tree_leaves(state.comm_residual)) > 0
    path = save_state(str(tmp_path), state, 3)
    restored = load_state(path, init_state(_params(3), cfg))
    _assert_states_equal(state, restored)
    live = state
    for i in range(3, 5):
        live, _ = step(live, _tb(i))
        restored, _ = step(restored, _tb(i))
    _assert_states_equal(live, restored)


def test_async_topo_roundtrip(tmp_path):
    """The async server's clocks, pull stamps, update counter and anchor
    stack: a run halted mid-window and resumed continues bit-identically
    (a clock or anchor reset would change which learners fire and what
    they push)."""
    cfg = _cfg(topology=tbase.TopologyConfig(
        kind="async", server=tbase.AsyncConfig(staleness=2,
                                               step_time=(1, 3))))
    step = make_meta_step(mlp_loss, cfg)
    state = init_state(_params(2), cfg)
    for i in range(2):
        state, _ = step(state, _tb(i))
    assert int(state.topo["clock"].max()) > 0  # mid-block
    path = save_state(str(tmp_path), state, 2)
    restored = load_state(path, init_state(_params(3), cfg))
    _assert_states_equal(state, restored)
    assert state.topo["clock"].dtype == torch.int32
    live = state
    for i in range(2, 6):
        live, _ = step(live, _tb(i))
        restored, _ = step(restored, _tb(i))
    _assert_states_equal(live, restored)


def _small_state(seed=0):
    return init_state(_params(seed), _cfg())


def test_manifest_written_only_when_given(tmp_path):
    """No run manifest by default (the port has no repro.obs); a given
    dict lands as JAX writes it, and the snapshot does not carry it."""
    state = _small_state()
    save_state(str(tmp_path / "a"), state, 1)
    assert not os.path.exists(tmp_path / "a" / "manifest.json")
    manifest = {"suite": "x", "steps": 3}
    path = save_state(str(tmp_path / "b"), state, 1, manifest=manifest)
    jsave_state(str(tmp_path / "c"), {"a": np.zeros(2)}, 1,
                manifest=manifest)
    got = (tmp_path / "b" / "manifest.json").read_text()
    assert json.loads(got) == manifest
    assert got == (tmp_path / "c" / "manifest.json").read_text()
    load_state(path, _small_state(1))


def test_kill_mid_save_falls_back_bit_exact(tmp_path):
    state = _small_state()
    good = save_state(str(tmp_path), state, 1)
    torn = save_state(str(tmp_path), state, 2, fault="torn")
    assert latest_checkpoint(str(tmp_path)) == torn
    assert latest_verified_checkpoint(str(tmp_path)) == good
    with pytest.raises(CheckpointVerifyError, match="sidecar"):
        verify_checkpoint(torn)
    restored = load_state(good, _small_state(1))
    _assert_states_equal(state, restored)


def test_corrupt_save_caught_by_crc(tmp_path):
    state = _small_state()
    good = save_state(str(tmp_path), state, 1)
    bad = save_state(str(tmp_path), state, 2, fault="corrupt")
    with pytest.raises(CheckpointVerifyError):
        verify_checkpoint(bad)
    with pytest.raises(JCheckpointVerifyError):
        jverify(bad)  # JAX's verifier refuses it too
    assert latest_verified_checkpoint(str(tmp_path)) == good


def test_truncated_npz_detected(tmp_path):
    state = _small_state()
    path = save_state(str(tmp_path), state, 1)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointVerifyError, match="torn write"):
        verify_checkpoint(path)
    assert latest_verified_checkpoint(str(tmp_path)) is None


def test_entry_set_mismatch_detected(tmp_path):
    path = save_state(str(tmp_path), {"a": np.arange(4.0),
                                      "b": np.ones((2, 2))}, 1)
    with open(path + CRC_SUFFIX) as f:
        sidecar = json.load(f)
    assert sorted(sidecar["entries"]) == ["a", "b"]
    del sidecar["entries"]["b"]
    with open(path + CRC_SUFFIX, "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(CheckpointVerifyError, match="entry set mismatch"):
        verify_checkpoint(path)


def test_nonfinite_snapshot_not_a_rollback_target(tmp_path):
    save_state(str(tmp_path), {"a": torch.tensor([1.0, float("nan")])}, 1)
    assert latest_verified_checkpoint(str(tmp_path)) is None
    assert latest_verified_checkpoint(str(tmp_path),
                                      check_finite=False) is not None


def test_torn_sidecar_tolerated(tmp_path):
    state = _small_state()
    good = save_state(str(tmp_path), state, 1)
    newer = save_state(str(tmp_path), state, 2)
    with open(newer + CRC_SUFFIX, "w") as f:
        f.write('{"npz_bytes": 12')
    with pytest.raises(CheckpointVerifyError, match="torn sidecar"):
        verify_checkpoint(newer)
    assert latest_verified_checkpoint(str(tmp_path)) == good


def test_retention_keeps_last_n_verified(tmp_path):
    state = _small_state()
    save_state(str(tmp_path), state, 1)
    save_state(str(tmp_path), state, 2, fault="torn")
    for s in (3, 4, 5):
        save_state(str(tmp_path), state, s, keep=2)
    snaps = sorted(f for f in os.listdir(str(tmp_path))
                   if f.endswith(".npz"))
    assert snaps == ["step_00000004.npz", "step_00000005.npz"]
    assert all(os.path.exists(os.path.join(str(tmp_path), f + CRC_SUFFIX))
               for f in snaps)


def test_verified_chain_before_step(tmp_path):
    state = _small_state()
    p2 = save_state(str(tmp_path), state, 2)
    p4 = save_state(str(tmp_path), state, 4)
    p5 = save_state(str(tmp_path), state, 5)
    assert [checkpoint_step(p) for p in (p2, p4, p5)] == [2, 4, 5]
    assert verified_checkpoints(str(tmp_path)) == [p2, p4, p5]
    assert verified_checkpoints(str(tmp_path), before_step=5) == [p2, p4]
    assert verified_checkpoints(str(tmp_path), before_step=2) == []


def test_prune_requires_positive_keep(tmp_path):
    with pytest.raises(AssertionError):
        prune_checkpoints(str(tmp_path), 0)


def test_prune_deletes_sidecar_with_snapshot(tmp_path):
    state = _small_state()
    for s in (1, 2, 3, 4):
        save_state(str(tmp_path), state, s)
    removed = prune_checkpoints(str(tmp_path), 2)
    assert [os.path.basename(p) for p in removed] == [
        "step_00000001.npz", "step_00000002.npz"]
    left = sorted(os.listdir(str(tmp_path)))
    assert not any(f.startswith("step_0000000" + str(s))
                   for s in (1, 2) for f in left)
    for s in (3, 4):
        assert f"step_0000000{s}.npz" in left
        assert f"step_0000000{s}.npz" + CRC_SUFFIX in left


def test_prune_sweeps_orphaned_sidecars(tmp_path):
    state = _small_state()
    for s in (1, 2):
        save_state(str(tmp_path), state, s)
    orphan = os.path.join(str(tmp_path), "step_00000099.npz" + CRC_SUFFIX)
    with open(orphan, "w") as f:
        f.write("{}")
    assert prune_checkpoints(str(tmp_path), 2) == []
    assert not os.path.exists(orphan)
    for s in (1, 2):
        assert os.path.exists(
            os.path.join(str(tmp_path), f"step_0000000{s}.npz" + CRC_SUFFIX))


def test_prune_interrupted_delete_sidecar_first_and_converges(
        tmp_path, monkeypatch):
    state = _small_state()
    for s in (1, 2, 3):
        save_state(str(tmp_path), state, s)
    p3 = os.path.join(str(tmp_path), "step_00000003.npz")
    calls = []
    real_remove = os.remove

    def interrupted_remove(p):
        calls.append(os.path.basename(p))
        if p.endswith(".npz"):
            raise OSError("interrupted mid-prune")
        return real_remove(p)

    monkeypatch.setattr(npz_mod.os, "remove", interrupted_remove)
    assert prune_checkpoints(str(tmp_path), 2) == []
    monkeypatch.setattr(npz_mod.os, "remove", real_remove)
    assert calls == ["step_00000001.npz" + CRC_SUFFIX, "step_00000001.npz"]
    leftover = os.path.join(str(tmp_path), "step_00000001.npz")
    assert os.path.exists(leftover)
    assert not os.path.exists(leftover + CRC_SUFFIX)
    assert latest_verified_checkpoint(str(tmp_path)) == p3
    save_state(str(tmp_path), state, 4)
    removed = prune_checkpoints(str(tmp_path), 2)
    assert [os.path.basename(p) for p in removed] == [
        "step_00000001.npz", "step_00000002.npz"]
    assert not os.path.exists(leftover)


def test_atomic_write_retries_a_transient_oserror(tmp_path, monkeypatch):
    """The npz and sidecar writes go through the bounded retry."""
    real_open, fails = open, {"n": 1}

    def flaky_open(p, mode="r", *a, **kw):
        if str(p).endswith(".tmp") and fails["n"]:
            fails["n"] -= 1
            raise OSError("transient")
        return real_open(p, mode, *a, **kw)

    monkeypatch.setattr("builtins.open", flaky_open)
    path = save_state(str(tmp_path), _small_state(), 1)
    monkeypatch.setattr("builtins.open", real_open)
    assert fails["n"] == 0
    verify_checkpoint(path)


def test_retry_io_backoff_then_success():
    calls, delays = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert retry.retry_io(flaky, sleep=delays.append) == "ok"
    assert calls["n"] == 3
    assert delays == [0.05, 0.05 * 2.0]


def test_retry_io_exhausts_loudly_and_only_retries_transient():
    calls = {"n": 0}

    def dead():
        calls["n"] += 1
        raise OSError("gone")

    with pytest.raises(OSError, match="gone"):
        retry.retry_io(dead, attempts=3, sleep=lambda d: None)
    assert calls["n"] == 3

    def broken():
        calls["n"] += 1
        raise ValueError("a bug, not an I/O hiccup")

    with pytest.raises(ValueError):
        retry.retry_io(broken, sleep=lambda d: None)
    assert calls["n"] == 4


@pytest.mark.parametrize("kw", [
    dict(attempts=1), dict(attempts=5), dict(attempts=5, jitter=0.5, seed=3),
    dict(attempts=4, base_delay=0.01, factor=3.0, jitter=1.0, seed=11),
])
def test_backoff_schedule_equals_jax(kw):
    assert retry.backoff_schedule(**kw) == jretry.backoff_schedule(**kw)


# ---------------------------------------------------------------------------
# part 2: each package on the other's files
# ---------------------------------------------------------------------------


def _config(base, case):
    """The MAvgConfig of ``case`` in either package (``base`` is the JAX
    or the port's configs module)."""
    kw = dict(algorithm="mavg", num_learners=2, k_steps=2, learner_lr=0.1,
              momentum=0.6)
    int8 = base.CommConfig(scheme="int8")
    if case == "flat-packed":
        pass
    elif case == "flat-per-leaf":
        kw.update(packed=False)
    elif case == "int8-ef-packed":
        kw.update(comm=int8)
    elif case == "int8-ef-per-leaf":
        kw.update(comm=int8, packed=False)
    elif case == "mlocal-packed":
        kw.update(algorithm="mavg_mlocal", local_momentum=0.5)
    elif case == "gossip-int8-ef":
        kw.update(num_learners=4, comm=int8,
                  topology=base.TopologyConfig(kind="gossip", graph="ring"))
    elif case == "hierarchical-elastic":
        kw.update(num_learners=4, topology=base.TopologyConfig(
            kind="hierarchical", groups=2, outer_every=2, inner_comm=int8,
            elastic=base.ElasticConfig(period=4, drop_frac=0.25, seed=1)))
    elif case == "robust-clip":
        kw.update(num_learners=4, robust=base.RobustConfig(
            estimator="trimmed", trim=1, clip_mult=3.0, clip_window=2))
    elif case == "async-packed":
        # halted mid-window: learner 1's 3-tick block is under way
        kw.update(topology=base.TopologyConfig(
            kind="async", server=base.AsyncConfig(staleness=2,
                                                  step_time=(1, 3))))
    elif case == "async-elastic-per-leaf":
        kw.update(num_learners=4, packed=False, topology=base.TopologyConfig(
            kind="async", server=base.AsyncConfig(staleness=3,
                                                  step_time=(1, 2, 3, 4)),
            elastic=base.ElasticConfig(period=3, drop_frac=0.25, seed=1)))
    elif case in ("bf16-packed", "bf16-per-leaf"):
        kw.update(compute_dtype="bfloat16", packed=case == "bf16-packed")
    else:
        raise ValueError(case)
    return base.MAvgConfig(**kw)


CASES = ["flat-packed", "flat-per-leaf", "int8-ef-packed", "int8-ef-per-leaf",
         "mlocal-packed", "gossip-int8-ef", "hierarchical-elastic",
         "async-packed", "async-elastic-per-leaf", "robust-clip",
         "bf16-packed", "bf16-per-leaf"]
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))


def _jax_run(jcfg, steps=2):
    state = jinit_state(JPARAMS, jcfg)
    step = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    L = jcfg.num_learners
    for i in range(steps):
        state, _ = step(state, _batches(20 + i, L=L))
    return state


def _sidecar(path):
    with open(path + CRC_SUFFIX) as f:
        return json.load(f)


def _words(a):
    """The raw bytes of an array as unsigned words of its item size."""
    a = np.array(a, order="C")  # keeps a 0-d array 0-d
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


@pytest.mark.parametrize("case", CASES)
def test_jax_and_port_load_each_others_checkpoints(tmp_path, case):
    jcfg, tcfg = _config(jbase, case), _config(tbase, case)
    jstate = _jax_run(jcfg)
    jpath = jsave_state(str(tmp_path / "jax"), jstate, 2)
    verify_checkpoint(jpath)  # the port verifies JAX's file

    template = init_state(interop.params_from_jax(JPARAMS), tcfg)
    state = load_state(jpath, template)
    assert state.step == int(jstate.step) == 2
    with np.load(jpath) as data:
        planes = _planes(state)
        assert {k for k, _ in planes} | {"step"} == (
            set(data.files) - {"__packspec__"})
        for k, v in planes:
            want = data[k]
            if v.dtype == torch.bfloat16:
                assert want.dtype == np.dtype("V2"), k
                got = v.view(torch.int16).numpy().view(np.uint16)
            else:
                assert v.numpy().dtype == want.dtype, k
                got = _words(v.numpy())
            assert got.shape == want.shape, k
            np.testing.assert_array_equal(got, _words(want), err_msg=k)
    for k in interop.HOST_TOPO_KEYS:
        if isinstance(state.topo, dict) and k in state.topo:
            assert state.topo[k].device.type == "cpu", k

    tpath = save_state(str(tmp_path / "port"), state, 2)
    jverify(tpath)  # JAX verifies the port's file
    assert _sidecar(tpath) == _sidecar(jpath)
    assert load_packspec(tpath) == load_packspec(jpath)
    if case.startswith("bf16"):
        # JAX's loader has no cast from |V2 words to bfloat16, for its own
        # file as for the port's (a departure of the reference)
        for p in (jpath, tpath):
            with pytest.raises(ValueError, match="cast"):
                jload_state(p, jax.eval_shape(lambda: jstate))
        return
    back = jload_state(tpath, jax.eval_shape(lambda: jstate))
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype, p
        np.testing.assert_array_equal(_words(a), _words(b), err_msg=str(p))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """After loading JAX's snapshot the port's next meta step gives JAX's
    next loss (rtol 1e-5: tanh and matmul sums differ by a few ulps)."""
    jcfg, tcfg = _config(jbase, "flat-packed"), _config(tbase, "flat-packed")
    jstate = _jax_run(jcfg)
    path = jsave_state(str(tmp_path), jstate, 2)
    state = load_state(path, init_state(interop.params_from_jax(JPARAMS),
                                        tcfg))
    b = _batches(30)
    _, jm = jax.jit(jmake_meta_step(jmlp_loss, jcfg))(jstate, b)
    _, m = make_meta_step(mlp_loss, tcfg)(state, interop.params_from_jax(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def test_jax_async_checkpoint_resumes_mid_window_in_the_port(tmp_path):
    """JAX halts the async run mid-window and saves; the port loads the
    file and runs on: its next four meta steps follow JAX's within rtol
    1e-5 / atol 1e-6, with the same fired counts and staleness."""
    jcfg, tcfg = (_config(jbase, "async-packed"),
                  _config(tbase, "async-packed"))
    jstate = _jax_run(jcfg)
    path = jsave_state(str(tmp_path), jstate, 2)
    state = load_state(path, init_state(interop.params_from_jax(JPARAMS),
                                        tcfg))
    jstep = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    step = make_meta_step(mlp_loss, tcfg)
    for i in range(4):
        b = _batches(40 + i)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, interop.params_from_jax(b))
        assert m["fired_count"] == float(jm["fired_count"])
        assert m["staleness_max"] == float(jm["staleness_max"])
        for k in ("global_params", "momentum", "learners"):
            np.testing.assert_allclose(
                getattr(state, k).numpy(),
                np.asarray(getattr(jstate, k)), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(state.topo["clock"].numpy(),
                                      np.asarray(jstate.topo["clock"]))


@pytest.mark.parametrize("case", ["flat-packed", "int8-ef-packed",
                                  "bf16-packed"])
def test_legacy_per_leaf_jax_checkpoint_into_packed_port(tmp_path, case):
    """A per-leaf JAX snapshot restores into a packed port template by
    packing each plane's leaves through the template's spec; the planes
    are those JAX's own legacy restore builds (for bf16, where JAX cannot
    load, those of JAX's pack_numpy on the words)."""
    tcfg = _config(tbase, case)
    jcfg_leaf = dataclasses.replace(_config(jbase, case), packed=False)
    jstate = _jax_run(jcfg_leaf)
    path = jsave_state(str(tmp_path), jstate, 2)
    template = init_state(interop.params_from_jax(JPARAMS), tcfg)
    state = load_state(path, template)
    assert state.step == 2 and state.spec is not None
    if case == "bf16-packed":
        from repro.pack import make_pack_spec as jmake_pack_spec

        jspec = jmake_pack_spec(JPARAMS)
        with np.load(path) as data:
            leaves = [data[f"learners/{p}"].view(np.uint16)
                      for p in jspec.paths]
        want = jspec.pack_numpy(leaves, dtype=np.uint16)
        np.testing.assert_array_equal(
            state.learners.view(torch.int16).numpy().view(np.uint16), want)
        return
    jpacked = jinit_state(JPARAMS, _config(jbase, case))
    want = jload_state(path, jax.eval_shape(lambda: jpacked))
    for k, v in _planes(state):
        node = want
        for part in k.split("/"):
            node = node[part] if isinstance(node, dict) else getattr(node,
                                                                     part)
        np.testing.assert_array_equal(v.numpy(), np.asarray(node), err_msg=k)


def test_packed_checkpoint_refuses_another_layout(tmp_path):
    path = save_state(str(tmp_path), _small_state(), 1)
    other = init_state(mlp_init(seeded_generator("cpu", 0), D, H + 1, C,
                                device="cpu"), _cfg())
    with pytest.raises(ValueError, match="layout"):
        load_state(path, other)
    with pytest.raises(ValueError, match="layout"):
        load_state(path, init_state(_params(), _cfg(packed=False)))


# ---------------------------------------------------------------------------
# part 3: the Trainer and the launcher
# ---------------------------------------------------------------------------


def _trainer(tmp_path, steps, chaos=None, every=2):
    tcfg = tbase.TrainConfig(
        model=tbase.get_config("qwen3-1.7b").reduced(), mavg=_cfg(),
        batch_per_learner=4, seq_len=1, meta_steps=steps, chaos=chaos,
        checkpoint_dir=str(tmp_path), checkpoint_every=every)

    def batch_fn(gen, step):
        x = torch.randn((2, 2, 4, D), generator=gen)
        return {"x": x, "y": torch.randint(0, C, (2, 2, 4), generator=gen)}

    return Trainer(tcfg, mlp_loss, init_params_fn=lambda gen: mlp_init(
        gen, D, H, C, device="cpu"), batch_fn=batch_fn, device="cpu")


def test_trainer_resume_is_bitwise(tmp_path):
    live = _trainer(tmp_path, 4)
    live.run(log=None)
    snaps = verified_checkpoints(str(tmp_path))
    assert [checkpoint_step(p) for p in snaps] == [2, 4]
    resumed = _trainer(tmp_path / "resumed", 2, every=0)
    resumed.restore(snaps[0])
    assert resumed.state.step == 2
    history = resumed.run(log=None)
    assert [h["meta_step"] for h in history] == [2, 3]
    assert [h["loss"] for h in history] == [h["loss"]
                                           for h in live.history[2:]]
    _assert_states_equal(live.state, resumed.state)


@pytest.mark.parametrize("kind", ["torn_save", "corrupt_save"])
def test_chaos_save_fault_resumes_from_last_verified(tmp_path, kind):
    """The chaos save fault lands on the step-4 snapshot; resume skips it
    and continues bitwise from step 2."""
    chaos = ChaosConfig(seed=0, horizon=8, faults=(FaultSpec(kind, step=4),))
    live = _trainer(tmp_path, 4, chaos=chaos)
    live.run(log=None)
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 4
    good = latest_verified_checkpoint(str(tmp_path))
    assert checkpoint_step(good) == 2
    resumed = _trainer(tmp_path / "resumed", 2, every=0)
    resumed.restore(good)
    resumed.run(log=None)
    _assert_states_equal(live.state, resumed.state)


def test_launcher_checkpoint_and_resume_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    common = ["--device", "cpu", "--learners", "2", "--k", "2", "--batch",
              "2", "--seq", "16", "--checkpoint-dir", ck]
    launch_train.main(common + ["--steps", "3", "--checkpoint-every", "1",
                                "--checkpoint-keep", "2"])
    assert [checkpoint_step(p) for p in verified_checkpoints(ck)] == [2, 3]
    capsys.readouterr()
    launch_train.main(common + ["--steps", "1", "--checkpoint-every", "1",
                                "--resume"])
    out = capsys.readouterr().out
    assert f"resumed from {os.path.join(ck, 'step_00000003.npz')}" in out
    assert "meta_step=3" in out and "eval loss" in out
    # JAX resumes the port launcher's snapshot
    jcfg = jbase.get_config("qwen3-1.7b").reduced()
    jmcfg = jbase.MAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                             learner_lr=0.3, momentum=0.7)
    template = jax.eval_shape(lambda: jinit_state(
        japi.init_params(jax.random.PRNGKey(0), jcfg), jmcfg))
    path = latest_verified_checkpoint(ck)
    jverify(path)
    back = jload_state(path, template)
    assert int(back.step) == 4
    with np.load(path) as data:
        np.testing.assert_array_equal(np.asarray(back.learners),
                                      data["learners"])


def test_launcher_resume_without_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        launch_train.main(["--device", "cpu", "--learners", "2", "--k", "1",
                           "--steps", "1", "--batch", "1", "--seq", "8",
                           "--checkpoint-dir", str(tmp_path), "--resume"])
