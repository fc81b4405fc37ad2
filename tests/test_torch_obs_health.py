"""The port's run-health watchdogs (``repro_torch.obs.health``) against the
JAX package's ``tests/test_obs_health.py``, case for case, and against the
JAX Trainer's alerts on the same inputs.

Mirrored invariants (see tests/test_obs_health.py): HLT1 rule semantics,
HLT2 alert record shape, HLT3 a NaN-loss run halts with a resumable
checkpoint and a valid log, HLT4 a healthy run is bitwise unaffected by
the watchdogs, HLT5 ``health_halt=False`` records but never stops.

Parity with JAX: the rules are JAX's field for field; the same records
fire the same alerts; and the MLP on JAX's params and NaN-poisoned
batches (L=2, K=2) fires the same alerts in rule, metric, severity and
meta_step through both Trainers.
"""
import dataclasses
import functools
import importlib.util
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.trainer import Trainer as JTrainer  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.obs import health as jhealth  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    AsyncConfig,
    MAvgConfig,
    ObsConfig,
    TopologyConfig,
    TrainConfig,
)
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    DEFAULT_RULES,
    HealthHalt,
    HealthMonitor,
    HealthRule,
    make_monitor,
)

torch.set_num_threads(2)

D, C, H = 8, 4, 16
L, K, B = 4, 2, 4

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_KEYS = ("meta_steps_per_sec", "samples_per_sec", "elapsed_s")


# ---------------------------------------------------------------------------
# HLT1: rule semantics
# ---------------------------------------------------------------------------


def _recs(metric, values, start=0):
    return [{"meta_step": start + i, metric: v} for i, v in enumerate(values)]


def test_hlt1_rule_validation():
    with pytest.raises(AssertionError):
        HealthRule("x", "loss", "bogus_kind")
    with pytest.raises(AssertionError):
        HealthRule("x", "loss", "max", severity="panic")


def test_hlt1_nonfinite_fires_on_nan_and_inf_only():
    mon = HealthMonitor([HealthRule("nf", "loss", "nonfinite",
                                    severity="fatal")])
    assert mon.observe(_recs("loss", [1.0, 0.5])) == []
    fired = mon.observe(_recs("loss", [float("nan")], start=2))
    assert len(fired) == 1 and fired[0]["rule"] == "nf"
    fired = mon.observe(_recs("loss", [float("inf")], start=3))
    assert len(fired) == 1
    assert mon.halt_requested
    assert mon.halt_alert["meta_step"] == 2  # the FIRST fatal alert


def test_hlt1_absolute_bounds():
    mon = HealthMonitor([
        HealthRule("too_big", "consensus_dist", "max", threshold=5.0),
        HealthRule("too_small", "mixing_spectral_gap", "min", threshold=1e-4),
    ])
    assert mon.observe([{"meta_step": 0, "consensus_dist": 5.0,
                         "mixing_spectral_gap": 1e-4}]) == []
    fired = mon.observe([{"meta_step": 1, "consensus_dist": 5.1,
                          "mixing_spectral_gap": 1e-5}])
    assert sorted(a["rule"] for a in fired) == ["too_big", "too_small"]
    assert not mon.halt_requested  # warn severity


def test_hlt1_rel_max_trailing_median():
    mon = HealthMonitor([HealthRule("div", "loss", "rel_max", threshold=10.0,
                                    window=8, min_history=4)])
    assert mon.observe(_recs("loss", [1.0, 1.0, 1.0, 500.0])) == []
    assert mon.observe(_recs("loss", [9.9], start=4)) == []
    fired = mon.observe(_recs("loss", [11.0], start=5))
    assert len(fired) == 1
    assert fired[0]["reference"] == pytest.approx(1.0)


def test_hlt1_rel_min_and_skipped_metric():
    mon = HealthMonitor([HealthRule("slow", "meta_steps_per_sec", "rel_min",
                                    threshold=0.1, min_history=4)])
    mon.observe(_recs("meta_steps_per_sec", [10.0, 10.0, 10.0, 10.0]))
    assert mon.observe([{"meta_step": 4, "loss": 1.0}]) == []
    assert mon.observe(_recs("meta_steps_per_sec", [2.0], start=5)) == []
    fired = mon.observe(_recs("meta_steps_per_sec", [0.9], start=6))
    assert len(fired) == 1 and fired[0]["rule"] == "slow"


def test_hlt1_nonfinite_never_enters_history():
    mon = HealthMonitor([
        HealthRule("nf", "loss", "nonfinite"),
        HealthRule("div", "loss", "rel_max", threshold=10.0, min_history=4),
    ])
    mon.observe(_recs("loss", [1.0, 1.0, float("nan"), 1.0, 1.0]))
    fired = mon.observe(_recs("loss", [11.0], start=5))
    assert [a["rule"] for a in fired] == ["div"]
    assert fired[0]["reference"] == pytest.approx(1.0)


def test_hlt2_alert_record_shape():
    mon = HealthMonitor([HealthRule("nf", "loss", "nonfinite",
                                    severity="fatal")])
    (alert,) = mon.observe(_recs("loss", [math.inf]))
    for key in ("kind", "rule", "metric", "value", "severity", "halt",
                "meta_step", "rule_kind", "threshold", "window"):
        assert key in alert, key
    assert alert["kind"] == "alert"
    assert alert["severity"] == "fatal" and alert["halt"] is True
    json.dumps(alert)


def test_hlt1_make_monitor_demotes_fatal():
    mon = make_monitor(halt=False)
    assert all(r.severity == "warn" for r in mon.rules)
    assert {r.name for r in mon.rules} == {r.name for r in DEFAULT_RULES}
    mon.observe(_recs("loss", [float("nan")]))
    assert mon.alerts and not mon.halt_requested


# ---------------------------------------------------------------------------
# the rules and the monitor against JAX's
# ---------------------------------------------------------------------------


def test_default_rules_equal_jax():
    assert [dataclasses.asdict(r) for r in DEFAULT_RULES] == [
        dataclasses.asdict(r) for r in jhealth.DEFAULT_RULES]
    assert [f.name for f in dataclasses.fields(HealthRule)] == [
        f.name for f in dataclasses.fields(jhealth.HealthRule)]


@pytest.mark.parametrize("halt", [True, False])
def test_monitor_fires_what_jax_fires(halt):
    """One stream of records through both monitors (default rules, with
    and without halting): the same alerts, the same halt, and the same
    seeded medians."""
    rng = np.random.default_rng(5)
    recs = []
    for s in range(40):
        recs.append({
            "meta_step": s,
            "loss": float("nan") if s == 31 else
            float(rng.uniform(1, 2) * (30.0 if s == 25 else 1.0)),
            "displacement_norm": float("inf") if s == 33 else 1.0,
            "consensus_dist": 1e3 if s == 20 else float(rng.uniform(1, 2)),
            "mixing_spectral_gap": 1e-5 if s == 12 else 0.3,
            "meta_steps_per_sec": 0.01 if s == 17 else 10.0,
            "staleness_p99": 40.0 if s == 3 else 1.0,
        })
    seed, tail = recs[:6], recs[6:]
    mon, jmon = make_monitor(halt=halt), jhealth.make_monitor(halt=halt)
    mon.seed(seed)
    jmon.seed(seed)
    got = [mon.observe(tail[i:i + 4]) for i in range(0, len(tail), 4)]
    want = [jmon.observe(tail[i:i + 4]) for i in range(0, len(tail), 4)]
    assert got == want
    assert mon.alerts and mon.halt_alert == jmon.halt_alert
    assert (mon.halt_alert is not None) == halt


# ---------------------------------------------------------------------------
# trainer integration
# ---------------------------------------------------------------------------


def _check_telemetry():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", os.path.join(_ROOT, "tools", "check_telemetry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch_fn(nan_after=None):
    def fn(gen, step):
        x = torch.randn((L, K, B, D), generator=gen)
        if nan_after is not None and step >= nan_after:
            x = x * float("nan")
        return {"x": x, "y": torch.randint(0, C, (L, K, B), generator=gen)}
    return fn


def _trainer(tmp_path, *, nan_after=None, run_dir=None, sink="jsonl",
             **obs_kw):
    mcfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=K,
                      learner_lr=0.1, momentum=0.6)
    if run_dir is None and sink in ("jsonl", "csv"):
        run_dir = str(tmp_path / "run")
    cfg = TrainConfig(
        model=None, mavg=mcfg, batch_per_learner=B, meta_steps=8,
        log_every=2, obs=ObsConfig(sink=sink, run_dir=run_dir, **obs_kw))
    return Trainer(cfg, mlp_loss,
                   init_params_fn=lambda gen: mlp_init(gen, D, H, C,
                                                       device="cpu"),
                   batch_fn=_batch_fn(nan_after), device="cpu")


def test_hlt3_nan_loss_halts_with_resumable_checkpoint(tmp_path):
    run_dir = str(tmp_path / "run")
    tr = _trainer(tmp_path, nan_after=2, run_dir=run_dir, health=True)
    with pytest.raises(HealthHalt) as ei:
        tr.run(8, log=lambda *_: None)
    tr.close()
    halt = ei.value
    assert halt.alert["rule"] == "nonfinite_loss"
    assert halt.alert["severity"] == "fatal"
    assert halt.checkpoint_path and os.path.exists(halt.checkpoint_path)
    assert os.path.dirname(halt.checkpoint_path).endswith("halt_ckpt")
    tr2 = _trainer(tmp_path, run_dir=str(tmp_path / "run2"))
    tr2.restore(halt.checkpoint_path)
    assert int(tr2.state.step) >= 2
    path = os.path.join(run_dir, "run.jsonl")
    recs = [json.loads(line) for line in open(path)]
    alerts = [r for r in recs if r["kind"] == "alert"]
    assert any(a["rule"] == "nonfinite_loss" and a["halt"] for a in alerts)
    ct = _check_telemetry()
    schema = ct.load_schema(os.path.join(_ROOT, "tools",
                                         "telemetry_schema.json"))
    assert ct.check_file(path, schema) == []


def test_hlt4_healthy_run_bitwise_unaffected_by_watchdogs(tmp_path):
    hists = {}
    for health in (False, True):
        tr = _trainer(tmp_path / str(health), sink="memory", health=health)
        hists[health] = tr.run(8, log=None)
        if health:
            assert tr._monitor is not None and tr._monitor.alerts == []

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in TIME_KEYS}
                for r in recs]

    assert strip(hists[False]) == strip(hists[True])


def test_hlt5_health_halt_off_records_but_never_stops(tmp_path):
    tr = _trainer(tmp_path, nan_after=2, sink="memory", health=True,
                  health_halt=False)
    hist = tr.run(8, log=None)
    assert len(hist) == 8
    assert tr._monitor.alerts and not tr._monitor.halt_requested
    assert all(a["severity"] == "warn" for a in tr._monitor.alerts)
    nf = [a for a in tr._monitor.alerts if a["rule"] == "nonfinite_loss"]
    assert nf and nf[0]["halt"] is False


# ---------------------------------------------------------------------------
# the Trainers' alerts on the same inputs
# ---------------------------------------------------------------------------

PL = 2


@functools.lru_cache(maxsize=None)
def _jinputs(steps, nan_after):
    data_rng, init_rng = jax.random.split(jax.random.PRNGKey(0))
    params = jax.device_get(jmlp_init(init_rng, D, H, C))
    batches = []
    for s in range(steps):
        kx, ky = jax.random.split(jax.random.fold_in(data_rng, s))
        x = jax.random.normal(kx, (PL, K, B, D))
        if s >= nan_after:
            x = x * jnp.float32(float("nan"))
        batches.append(jax.device_get(
            {"x": x, "y": jax.random.randint(ky, (PL, K, B), 0, C)}))
    return params, batches


def test_alerts_match_jax(tmp_path):
    """NaN batches from step 2 with the halt off: both Trainers emit the
    same alert sequence, in the history's order and in the run log."""
    steps, nan_after = 6, 2
    params, batches = _jinputs(steps, nan_after)
    kw = dict(algorithm="mavg", num_learners=PL, k_steps=K, learner_lr=0.1,
              momentum=0.6)
    obs = dict(sink="jsonl", health=True, health_halt=False)
    jt = JTrainer(
        jbase.TrainConfig(model=None, mavg=jbase.MAvgConfig(**kw),
                          batch_per_learner=B, meta_steps=steps, log_every=2,
                          obs=jbase.ObsConfig(run_dir=str(tmp_path / "j"),
                                              **obs)),
        jmlp_loss, init_params_fn=lambda rng: jmlp_init(rng, D, H, C),
        batch_fn=lambda rng, s: batches[s])
    jt.run(steps, log=None)
    jt.close()
    tt = Trainer(
        TrainConfig(model=None, mavg=MAvgConfig(**kw), batch_per_learner=B,
                    meta_steps=steps, log_every=2,
                    obs=ObsConfig(run_dir=str(tmp_path / "t"), **obs)),
        mlp_loss, init_params_fn=lambda gen: interop.params_from_jax(params),
        batch_fn=lambda gen, s: interop.params_from_jax(batches[s]),
        device="cpu")
    tt.run(steps, log=None)
    tt.close()

    def key(a):
        return (a["rule"], a["metric"], a["severity"], a["meta_step"])

    want = [key(a) for a in jt._monitor.alerts]
    assert want and [key(a) for a in tt._monitor.alerts] == want
    assert ("nonfinite_loss", "loss", "warn", nan_after) in want
    for d in ("j", "t"):
        recs = [json.loads(line)
                for line in open(tmp_path / d / "run.jsonl")]
        assert [key(r) for r in recs if r["kind"] == "alert"] == want


def test_staleness_runaway_fires_as_jax(tmp_path):
    """The async server reports ``staleness_p99``, so the
    ``staleness_runaway`` rule (p99 over 32) now has its metric: learner 1
    at 40 ticks a block (tau 39) pushes with staleness 39 at tick 40, and
    both Trainers raise the same alerts on the same inputs."""
    steps = 44
    params, batches = _jinputs(steps, steps)
    kw = dict(algorithm="mavg", num_learners=PL, k_steps=K, learner_lr=0.1,
              momentum=0.6)
    obs = dict(sink="none", health=True, health_halt=False)
    jt = JTrainer(
        jbase.TrainConfig(
            model=None, mavg=jbase.MAvgConfig(**kw, topology=(
                jbase.TopologyConfig(kind="async", server=jbase.AsyncConfig(
                    staleness=39, step_time=(1, 40))))),
            batch_per_learner=B, meta_steps=steps, log_every=4,
            obs=jbase.ObsConfig(**obs)),
        jmlp_loss, init_params_fn=lambda rng: jmlp_init(rng, D, H, C),
        batch_fn=lambda rng, s: batches[s])
    jt.run(steps, log=None)
    tt = Trainer(
        TrainConfig(model=None, mavg=MAvgConfig(**kw, topology=(
            TopologyConfig(kind="async", server=AsyncConfig(
                staleness=39, step_time=(1, 40))))),
            batch_per_learner=B, meta_steps=steps, log_every=4,
            obs=ObsConfig(**obs)),
        mlp_loss, init_params_fn=lambda gen: interop.params_from_jax(params),
        batch_fn=lambda gen, s: interop.params_from_jax(batches[s]),
        device="cpu")
    tt.run(steps, log=None)

    def key(a):
        return (a["rule"], a["metric"], a["severity"], a["meta_step"])

    want = [key(a) for a in jt._monitor.alerts]
    assert [key(a) for a in tt._monitor.alerts] == want
    assert any(a[0] == "staleness_runaway" and a[3] == 40 for a in want), want
    assert [r["staleness_p99"] for r in tt.history] == pytest.approx(
        [r["staleness_p99"] for r in jt.history])
    jt.close()
    tt.close()
