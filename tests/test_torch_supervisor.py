"""The port's supervised recovery (``repro_torch.core.supervisor``) against
the JAX package's ``tests/test_chaos.py`` CH4 (supervised recovery) and
CH5 (sink resilience) cases, and against the JAX Supervisor on the same
inputs.

Mirrored: a transient NaN burst halts the run and the supervisor rolls
back through the verified chain and completes with schema-valid
telemetry; a sticky fault exhausts the retry budget; rollback is causal
and walks back one snapshot per stalled retry; quarantine masks a
learner for its probation window (with hysteresis) and readmits it; the
JSONL sink survives a transient OSError.

Parity with JAX: the MLP on JAX's params and teacher-classification
batches (re-salted per retry as JAX re-salts them), L=2, K=2, the finite
guard on, ``nan_batch`` at step 3 on learner 0: the fault and recovery
records agree (fault, learner, meta step, attempt, policy) and the final
planes agree to rtol 1e-5.

Where the port departs: before it builds a retry's trainer, the port's
supervisor releases the failed one (its sink closed, its state dropped),
so one card never holds two states.
"""
import functools
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.chaos import ChaosConfig as JChaosConfig  # noqa: E402
from repro.chaos import FaultSpec as JFaultSpec  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import Supervisor as JSupervisor  # noqa: E402
from repro.core import Trainer as JTrainer  # noqa: E402
from repro.data import classif_batch_fn as jclassif_batch_fn  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.chaos import ChaosConfig, FaultSpec  # noqa: E402
from repro_torch.checkpoint import checkpoint_step, save_state  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    MAvgConfig,
    ObsConfig,
    TopologyConfig,
    TrainConfig,
)
from repro_torch.core.supervisor import (  # noqa: E402
    RecoveryExhausted,
    RecoveryPolicy,
    Supervisor,
)
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.data.synthetic import classif_batch_fn  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.obs import HealthHalt  # noqa: E402
from repro_torch.obs.sink import JsonlSink  # noqa: E402

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

L, K, B, D, C = 2, 2, 4, 8, 4


def _check_telemetry():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", os.path.join(_ROOT, "tools", "check_telemetry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _valid_log(path):
    ct = _check_telemetry()
    schema = ct.load_schema(os.path.join(_ROOT, "tools",
                                         "telemetry_schema.json"))
    with open(path) as f:
        return ct.check_stream(f, schema)


def _mcfg(**kw):
    kw.setdefault("num_learners", L)
    kw.setdefault("learner_lr", 0.1)
    return MAvgConfig(algorithm="mavg", k_steps=K, momentum=0.6, **kw)


# ---------------------------------------------------------------------------
# CH4: supervised recovery
# ---------------------------------------------------------------------------


def _make_trainer_factory(tmp_path, chaos, *, steps=8, built=None):
    ckpt = str(tmp_path / "ckpt")
    run_dir = str(tmp_path / "run")

    def make_trainer(plan):
        if built:  # the failed attempt was released before this call
            built.append(("previous state", built[-1][1].state))
        mcfg = _mcfg(learner_lr=0.1 * plan.lr_scale, finite_guard=True)
        tcfg = TrainConfig(
            model=None, mavg=mcfg, batch_per_learner=B, meta_steps=steps,
            seed=0, log_every=1, checkpoint_dir=ckpt, checkpoint_every=2,
            chaos=chaos, data_salt=plan.data_salt,
            obs=ObsConfig(sink="jsonl", run_dir=run_dir, health=True),
        )
        tr = Trainer(
            tcfg, mlp_loss,
            init_params_fn=lambda gen: mlp_init(gen, D, 16, C, device="cpu"),
            batch_fn=classif_batch_fn(D, C, L, K, B, device="cpu"),
            device="cpu")
        if built is not None:
            built.append(("trainer", tr))
        return tr

    return make_trainer, ckpt, run_dir


def test_ch4_supervised_recovery_completes(tmp_path):
    """A transient NaN burst halts the run; the supervisor rolls back
    through the verified chain and the retry (fault dropped by the salt)
    completes the target steps with schema-valid telemetry. The failed
    attempt's state was dropped before the retry's trainer was built."""
    steps = 8
    chaos = ChaosConfig(seed=0, horizon=steps, faults=(
        FaultSpec("nan_batch", step=3, learner=0),))
    built = []
    make_trainer, ckpt, run_dir = _make_trainer_factory(
        tmp_path, chaos, steps=steps, built=built)
    sup = Supervisor(make_trainer, target_steps=steps, checkpoint_dir=ckpt)
    trainer, history = sup.run(log=None)
    assert int(trainer.state.step) == steps
    for x in (trainer.state.global_params, trainer.state.learners):
        assert torch.isfinite(x).all()

    faults = [r for r in sup.records if r.get("kind") == "fault"]
    recoveries = [r for r in sup.records if r.get("kind") == "recovery"]
    assert faults and faults[0]["fault"] == "nonfinite_loss"
    assert faults[0]["learner"] == 0  # the schedule's attribution oracle
    assert recoveries and recoveries[0]["attempt"] == 1
    assert "rollback" in recoveries[0]["policy"]
    assert [kind for kind, _ in built] == [
        "trainer", "previous state", "trainer"]
    assert built[1][1] is None and built[0][1]._sink is None
    trainer.close()
    assert _valid_log(os.path.join(run_dir, "run.jsonl")) == []
    assert [r["meta_step"] for r in history][-1] == steps - 1


def test_ch4_sticky_fault_exhausts_retries(tmp_path):
    steps = 8
    chaos = ChaosConfig(seed=0, horizon=steps, faults=(
        FaultSpec("nan_batch", step=1, learner=0, sticky=True),))
    make_trainer, ckpt, _ = _make_trainer_factory(tmp_path, chaos,
                                                  steps=steps)
    sup = Supervisor(make_trainer, target_steps=steps, checkpoint_dir=ckpt,
                     policy=RecoveryPolicy(max_retries=1))
    with pytest.raises(RecoveryExhausted) as ei:
        sup.run(log=None)
    assert ei.value.fault["fault"] == "nonfinite_loss"
    assert any(r.get("rule") == "recovery_exhausted" for r in sup.records)


def test_ch4_rollback_is_causal_and_walks_back(tmp_path):
    """Never resume from a snapshot at/after the fault step; a retry that
    stalls without progress walks one snapshot further back, down to a
    scratch restart."""
    tree = {"a": torch.arange(4.0)}
    ckpt = str(tmp_path)
    for s in (2, 4, 5):  # 5 plays the emergency halt snapshot
        save_state(ckpt, tree, s)

    class _FakeTrainer:
        def __init__(self):
            self.state = SimpleNamespace(step=0)
            self.history = []
            self._monitor = None

        def restore(self, path):
            self.state.step = checkpoint_step(path)

        def run(self, remaining, log=None):
            self.state.step = 5
            raise HealthHalt({"rule": "loss_divergence", "metric": "loss",
                              "value": 99.0, "meta_step": 4})

        def emit(self, record):
            pass

        def close(self):
            pass

    sup = Supervisor(lambda plan: _FakeTrainer(), target_steps=10,
                     checkpoint_dir=ckpt,
                     policy=RecoveryPolicy(max_retries=3))
    with pytest.raises(RecoveryExhausted):
        sup.run(log=None)
    resumes = [(r["meta_step"], r["resume_path"])
               for r in sup.records if r.get("kind") == "recovery"]
    assert [s for s, _ in resumes] == [4, 2, 0]
    assert resumes[-1][1] is None


def _quarantine_trainer():
    """A membership-capable run: gossip with a crash window (the JAX
    cases use the async server, which is not ported: ROADMAP Queue 1,
    item 6; any membership schedule serves)."""
    mcfg = _mcfg(num_learners=4, topology=TopologyConfig(kind="gossip",
                                                          graph="ring"))
    chaos = ChaosConfig(seed=0, horizon=8, faults=(
        FaultSpec("crash", step=6, learner=3),))
    tcfg = TrainConfig(model=None, mavg=mcfg, batch_per_learner=B,
                       meta_steps=8, seed=0, chaos=chaos,
                       obs=ObsConfig(sink="none"))
    return Trainer(
        tcfg, mlp_loss,
        init_params_fn=lambda gen: mlp_init(gen, D, 16, C, device="cpu"),
        batch_fn=classif_batch_fn(D, C, 4, K, B, device="cpu"),
        device="cpu")


@pytest.mark.parametrize("readmit,probation", [(1, (2, 4)), (2, (2, 6))],
                         ids=["single-window", "hysteresis"])
def test_ch4_quarantine_masks_then_readmits(readmit, probation):
    """Quarantine rewrites the membership window after the resume step
    (probation of ``quarantine_steps * readmit_clean_windows`` rows),
    leaves later rows untouched (readmission) and never empties a row."""
    trainer = _quarantine_trainer()
    sup = Supervisor(lambda plan: trainer, target_steps=8,
                     checkpoint_dir=None,
                     policy=RecoveryPolicy(quarantine_steps=2,
                                           readmit_clean_windows=readmit))
    sup._quarantine(trainer, (1,), 2)
    m = np.asarray(trainer.state.topo["membership"])
    lo, hi = probation
    assert (m[lo:hi, 1] == 0.0).all()           # probation window
    assert m[hi, 1] == 1.0 and m[1, 1] == 1.0   # readmitted / untouched
    assert (m.sum(axis=1) >= 1.0).all()
    trainer.close()


def test_ch4_readmit_clean_windows_validation():
    with pytest.raises(AssertionError):
        RecoveryPolicy(readmit_clean_windows=0)


# ---------------------------------------------------------------------------
# CH5: sink resilience
# ---------------------------------------------------------------------------


def _flaky_write(self, real, s):
    if self.fails:
        self.fails -= 1
        raise OSError("EAGAIN")
    return real.write(s)


def test_ch5_jsonl_sink_survives_transient_oserror(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sink = JsonlSink(path)
    real = sink._f
    flaky = SimpleNamespace(
        fails=1,
        write=lambda s: _flaky_write(flaky, real, s),
        flush=real.flush,
        close=real.close,
        closed=False,
    )
    sink._f = flaky
    sink.append({"kind": "step", "meta_step": 0, "loss": 1.0})
    sink.flush()
    real.close()
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    assert len(lines) == 1 and '"loss": 1.0' in lines[0]


# ---------------------------------------------------------------------------
# the port's Supervisor against JAX's on the same inputs
# ---------------------------------------------------------------------------

JBATCH_FN = jclassif_batch_fn(D, C, L, K, B)


def _jax_streams(salt):
    data_rng, init_rng = jax.random.split(jax.random.PRNGKey(0))
    if salt:
        data_rng = jax.random.fold_in(data_rng, salt)
    return data_rng, init_rng


@functools.lru_cache(maxsize=None)
def _jparams():
    return jax.device_get(jmlp_init(_jax_streams(0)[1], D, 16, C))


@functools.lru_cache(maxsize=None)
def _jbatch(step, salt):
    return jax.device_get(JBATCH_FN(
        jax.random.fold_in(_jax_streams(salt)[0], step), step))


def test_supervised_recovery_matches_jax(tmp_path):
    steps = 8
    fault = dict(kind="nan_batch", step=3, learner=0)

    def jmake(plan):
        mcfg = jbase.MAvgConfig(algorithm="mavg", num_learners=L, k_steps=K,
                                momentum=0.6, learner_lr=0.1 * plan.lr_scale,
                                finite_guard=True)
        return JTrainer(
            jbase.TrainConfig(
                model=None, mavg=mcfg, batch_per_learner=B, meta_steps=steps,
                log_every=1, checkpoint_dir=str(tmp_path / "jck"),
                checkpoint_every=2,
                chaos=JChaosConfig(seed=0, horizon=steps,
                                   faults=(JFaultSpec(**fault),)),
                data_salt=plan.data_salt,
                obs=jbase.ObsConfig(sink="jsonl",
                                    run_dir=str(tmp_path / "jrun"),
                                    health=True)),
            jmlp_loss, init_params_fn=lambda rng: jmlp_init(rng, D, 16, C),
            batch_fn=JBATCH_FN)

    def tmake(plan):
        mcfg = _mcfg(learner_lr=0.1 * plan.lr_scale, finite_guard=True)
        return Trainer(
            TrainConfig(
                model=None, mavg=mcfg, batch_per_learner=B, meta_steps=steps,
                log_every=1, checkpoint_dir=str(tmp_path / "tck"),
                checkpoint_every=2,
                chaos=ChaosConfig(seed=0, horizon=steps,
                                  faults=(FaultSpec(**fault),)),
                data_salt=plan.data_salt,
                obs=ObsConfig(sink="jsonl", run_dir=str(tmp_path / "trun"),
                              health=True)),
            mlp_loss,
            init_params_fn=lambda gen: interop.params_from_jax(_jparams()),
            batch_fn=lambda gen, s, salt=plan.data_salt:
                interop.params_from_jax(_jbatch(s, salt)),
            device="cpu")

    jsup = JSupervisor(jmake, target_steps=steps,
                       checkpoint_dir=str(tmp_path / "jck"))
    jtr, jhist = jsup.run(log=None)
    jtr.close()
    tsup = Supervisor(tmake, target_steps=steps,
                      checkpoint_dir=str(tmp_path / "tck"))
    ttr, thist = tsup.run(log=None)
    ttr.close()

    def key(r):
        if r["kind"] == "fault":
            return ("fault", r["fault"], r.get("learner"), r["meta_step"],
                    r["attempt"])
        if r["kind"] == "recovery":
            return ("recovery", r["policy"], r["attempt"], r["meta_step"],
                    os.path.basename(r["resume_path"] or ""))
        return ("alert", r["rule"], r["meta_step"])

    want = [key(r) for r in jsup.records]
    assert want[:2] == [("fault", "nonfinite_loss", 0, 4, 0),
                        ("recovery", "rollback+lr_backoff+resalt", 1, 2,
                         "step_00000002.npz")]
    assert [key(r) for r in tsup.records] == want
    assert int(ttr.state.step) == int(jtr.state.step) == steps
    for name in ("global_params", "momentum", "learners"):
        np.testing.assert_allclose(
            getattr(ttr.state, name).numpy(),
            np.asarray(jax.device_get(getattr(jtr.state, name))),
            rtol=1e-5, atol=1e-6, err_msg=name)
    assert [r["meta_step"] for r in thist] == [r["meta_step"] for r in jhist]
    np.testing.assert_allclose([r["loss"] for r in thist],
                               [r["loss"] for r in jhist], rtol=1e-5)
    for run in ("jrun", "trun"):
        path = os.path.join(tmp_path, run, "run.jsonl")
        assert _valid_log(path) == [], run
        kinds = [json.loads(line)["kind"] for line in open(path)]
        assert kinds.count("fault") == kinds.count("recovery") == 1


# ---------------------------------------------------------------------------
# the launcher's --supervise
# ---------------------------------------------------------------------------


def test_launcher_supervised_run_on_cpu(tmp_path, capsys):
    run_dir = tmp_path / "run"
    launch_train.main(["--device", "cpu", "--learners", "2", "--k", "2",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--checkpoint-dir", str(tmp_path / "ck"),
                       "--checkpoint-every", "2", "--supervise",
                       "--supervise-retries", "2", "--obs-sink", "jsonl",
                       "--run-dir", str(run_dir), "--obs-health"])
    assert "final train loss" in capsys.readouterr().out
    assert _valid_log(str(run_dir / "run.jsonl")) == []
    assert "step_00000004.npz" in os.listdir(tmp_path / "ck")
