"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``tests/test_obs.py``, case for case, and against the JAX Trainer's run
logs on the same inputs.

Mirrored invariants (see tests/test_obs.py): OBS1 ring fidelity, OBS2
the history equals the sink, OBS3 one host read per flush, OBS4 resume
appends to the same log, OBS5 topology health metrics, OBS6 the schema
checker, OBS7 exception-safe tracing, OBS8 torn-tail repair, OBS9 schema
versions.

Parity with JAX: the MLP on the teacher-classification stream, L=2, K=2,
flat dense, JAX's params and batches carried over as numpy arrays; the
two run logs have the same record kinds and keys, their step metrics
agree to rtol 1e-5 (timing keys excluded), both pass
``tools/check_telemetry.py``, and the PackSpec hashes are equal.
"""
import csv
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
from repro.data import classif_batch_fn as jclassif_batch_fn  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.obs import packspec_hash as jpackspec_hash  # noqa: E402
from repro.pack import make_pack_spec as jmake_pack_spec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    MAvgConfig,
    ObsConfig,
    TopologyConfig,
    TrainConfig,
)
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    SCHEMA_VERSION,
    JsonlSink,
    MetricsBuffer,
    Tracer,
    metric_keys,
    packspec_hash,
    run_manifest,
    write_row,
)
from repro_torch.obs.sink import _jsonify, _repair_torn_tail  # noqa: E402
from repro_torch.pack import make_pack_spec  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
L, K, B = 4, 2, 4

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# host-side wall-clock fields: legitimately differ between runs
TIME_KEYS = ("meta_steps_per_sec", "samples_per_sec", "elapsed_s")


def _check_telemetry():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", os.path.join(_ROOT, "tools", "check_telemetry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _schema(ct):
    return ct.load_schema(os.path.join(_ROOT, "tools",
                                       "telemetry_schema.json"))


def _batch_fn(gen, step):
    return {"x": torch.randn((L, K, B, D), generator=gen),
            "y": torch.randint(0, C, (L, K, B), generator=gen)}


def _trainer(tmp_path=None, *, donate=True, sink="memory", topology=None,
             log_every=2, checkpoint=False, run_dir=None, **obs_kw):
    mcfg = MAvgConfig(
        algorithm="mavg", num_learners=L, k_steps=K, learner_lr=0.1,
        momentum=0.6, donate=donate,
        **({"topology": topology} if topology else {}),
    )
    if run_dir is None and sink in ("jsonl", "csv"):
        run_dir = str(tmp_path / "run")
    cfg = TrainConfig(
        model=None, mavg=mcfg, batch_per_learner=B, meta_steps=8,
        log_every=log_every,
        checkpoint_dir=str(tmp_path / "ckpt") if checkpoint else None,
        checkpoint_every=2 if checkpoint else 0,
        obs=ObsConfig(sink=sink, run_dir=run_dir, **obs_kw),
    )
    return Trainer(cfg, mlp_loss,
                   init_params_fn=lambda gen: mlp_init(gen, D, H, C,
                                                       device="cpu"),
                   batch_fn=_batch_fn, device="cpu")


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in TIME_KEYS}
            for r in recs]


# ---------------------------------------------------------------------------
# OBS1: flush decodes bitwise what per-step reads would have seen
# ---------------------------------------------------------------------------


def test_obs1_ring_flush_bitwise_vs_per_step_reads():
    rng = np.random.RandomState(3)
    rows = [{"loss": torch.tensor(np.float32(rng.randn())),
             "gnorm": torch.tensor(np.float32(rng.randn()))}
            for _ in range(5)]
    keys = metric_keys(rows[0])
    mb = MetricsBuffer(keys, capacity=5)
    for i, m in enumerate(rows):
        mb.append(m, step=i)
    flushed = mb.flush()
    assert mb.host_syncs == 1
    assert [r["meta_step"] for r in flushed] == list(range(5))
    for rec, m in zip(flushed, rows):
        for k in keys:
            assert rec[k] == float(m[k]), k


def test_obs1_write_row_matches_append():
    keys = ("a", "b")
    buf = torch.zeros(3, 2)
    mb = MetricsBuffer(keys, capacity=3)
    for i in range(3):
        a, b = torch.tensor(i + 0.5), torch.tensor(float(-i))
        write_row(buf, i, {"a": a, "b": b}, keys)
        mb.append({"a": a, "b": b}, step=i)
    assert torch.equal(buf, mb.buf)
    assert [r["a"] for r in mb.flush()] == [0.5, 1.5, 2.5]


def test_obs1_host_values_take_their_f32_rounding():
    """Metrics the step computed on the host (Python floats, numpy
    scalars) land in the ring as the f32 JAX's ``jnp.asarray`` gives."""
    mb = MetricsBuffer(("a", "b", "c"), capacity=1)
    mb.append({"a": 0.1, "b": np.float64(1 / 3), "c": torch.tensor(7)}, 0)
    (rec,) = mb.flush()
    assert rec["a"] == float(np.float32(0.1))
    assert rec["b"] == float(jnp.asarray(1 / 3, jnp.float32))
    assert rec["c"] == 7.0


def test_obs1_overflow_guard():
    mb = MetricsBuffer(("a",), capacity=2)
    mb.append({"a": torch.tensor(1.0)}, step=0)
    mb.append({"a": torch.tensor(2.0)}, step=1)
    with pytest.raises(RuntimeError):
        mb.append({"a": torch.tensor(3.0)}, step=2)
    assert len(mb.flush()) == 2


# ---------------------------------------------------------------------------
# OBS2: history and sink records are the same across donate
# ---------------------------------------------------------------------------


def test_obs2_history_and_sink_parity_across_donation(tmp_path):
    """The port's step is in place whatever ``donate`` says; the records
    agree across it, and the sink sees what the history sees."""
    hists, sinks = {}, {}
    for donate in (False, True):
        tr = _trainer(tmp_path / str(donate), donate=donate, sink="memory")
        hists[donate] = tr.run(8, log=None)
        sinks[donate] = tr._sink.records
    assert _strip(hists[False]) == _strip(hists[True])
    assert _strip(sinks[False]) == _strip(sinks[True])
    assert _strip(hists[True]) == _strip(sinks[True])


# ---------------------------------------------------------------------------
# OBS3: host reads == boundary flushes + the final flush, nothing else
# ---------------------------------------------------------------------------


def test_obs3_sync_count_with_logging(tmp_path):
    tr = _trainer(tmp_path, sink="memory", log_every=4)
    tr.run(8, log=lambda *_: None)
    # boundaries at steps 0 and 4 + the final flush of steps 5..7
    assert tr._mb.host_syncs == 3
    assert len(tr.history) == 8


def test_obs3_sync_count_silent_run(tmp_path):
    tr = _trainer(tmp_path, sink="memory", log_every=4)
    tr.run(8, log=None)
    # capacity = log_every = 4: the forced flush when full at step 4 and
    # the final flush of steps 4..7
    assert tr._mb.host_syncs == 2
    assert [r["meta_step"] for r in tr.history] == list(range(8))


def test_obs3_throughput_fields(tmp_path):
    tr = _trainer(tmp_path, sink="memory", log_every=2)
    hist = tr.run(4, log=lambda *_: None)
    for r in hist:
        assert r["meta_steps_per_sec"] > 0
        assert r["samples_per_sec"] == pytest.approx(
            r["meta_steps_per_sec"] * L * K * B)
        assert r["elapsed_s"] > 0
        assert r["samples"] == (r["meta_step"] + 1) * L * K * B


# ---------------------------------------------------------------------------
# OBS4: resume appends to the same run log, monotone meta_step
# ---------------------------------------------------------------------------


def test_obs4_resume_appends_same_run_log(tmp_path):
    run_dir = str(tmp_path / "run")
    tr = _trainer(tmp_path, sink="jsonl", run_dir=run_dir, checkpoint=True)
    tr.run(4, log=None)
    tr.close()

    from repro_torch.checkpoint import latest_checkpoint

    tr2 = _trainer(tmp_path, sink="jsonl", run_dir=run_dir, checkpoint=True)
    tr2.restore(latest_checkpoint(str(tmp_path / "ckpt")))
    tr2.run(4, log=None)
    tr2.close()

    path = os.path.join(run_dir, "run.jsonl")
    recs = [json.loads(line) for line in open(path)]
    manifests = [r for r in recs if r["kind"] == "manifest"]
    steps = [r["meta_step"] for r in recs if r["kind"] == "step"]
    assert len(manifests) == 2  # one per (re)open
    assert steps == sorted(steps) and len(set(steps)) == len(steps)
    assert steps[0] == 0 and steps[-1] == 7
    # the checkpoint directory carries the manifest sidecar
    man = json.load(open(tmp_path / "ckpt" / "manifest.json"))
    assert man["schema_version"] == SCHEMA_VERSION
    ct = _check_telemetry()
    assert ct.check_file(path, _schema(ct)) == []


# ---------------------------------------------------------------------------
# OBS5: topology health metrics
# ---------------------------------------------------------------------------


def test_obs5_flat_metrics_present(tmp_path):
    tr = _trainer(tmp_path, sink="memory")
    hist = tr.run(2, log=None)
    for key in ("loss", "grad_norm", "loss_spread", "consensus_dist",
                "displacement_norm", "v_norm", "comm_bytes",
                "comm_bytes_dense", "comm_compression"):
        assert key in hist[0], key
    assert hist[0]["loss_spread"] >= 0
    assert hist[0]["consensus_dist"] > 0  # K local steps drove them apart
    assert hist[0]["comm_compression"] == pytest.approx(1.0)  # dense


def test_obs5_hierarchical_consensus(tmp_path):
    topo = TopologyConfig(kind="hierarchical", groups=2, outer_every=2)
    tr = _trainer(tmp_path, sink="memory", topology=topo)
    hist = tr.run(2, log=None)
    assert "consensus_dist" in hist[0]
    assert "comm_bytes_inter" in hist[0] and "comm_bytes_intra" in hist[0]


def test_obs5_gossip_spectral_gap_matches_numpy(tmp_path):
    topo = TopologyConfig(kind="gossip", graph="ring")
    tr = _trainer(tmp_path, sink="memory", topology=topo)
    hist = tr.run(2, log=None)
    from repro_torch.topology.gossip import mixing_matrix

    lam = np.sort(np.linalg.eigvalsh(np.asarray(mixing_matrix("ring", L, 0))))
    assert hist[0]["mixing_spectral_gap"] == pytest.approx(1.0 - lam[-2],
                                                           rel=1e-5)


def test_obs5_spectral_gap_masked_identity_rows():
    from repro_torch.topology.elastic import mask_mixing_matrix
    from repro_torch.topology.gossip import mixing_matrix, spectral_gap

    W = mixing_matrix("complete", 4, 0)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
    Wm = mask_mixing_matrix(W, mask)
    gap = float(spectral_gap(Wm, mask))
    present = np.ix_([0, 1, 3], [0, 1, 3])
    lam = np.sort(np.linalg.eigvalsh(Wm.numpy()[present]))
    assert lam[-1] == pytest.approx(1.0, abs=1e-6)  # doubly stochastic
    assert gap == pytest.approx(1.0 - lam[-2], abs=1e-5)
    # undeflated, the masked matrix's gap reads 0
    assert float(spectral_gap(Wm)) == pytest.approx(0.0, abs=1e-5)


# ---------------------------------------------------------------------------
# OBS6: the schema checker on the port's logs; the CSV sink
# ---------------------------------------------------------------------------


def _valid_lines(tmp_path):
    run_dir = str(tmp_path / "run")
    tr = _trainer(tmp_path, sink="jsonl", run_dir=run_dir)
    tr.run(3, log=None)
    tr.close()
    return open(os.path.join(run_dir, "run.jsonl")).read().splitlines()


def test_obs6_checker_accepts_and_rejects(tmp_path):
    ct = _check_telemetry()
    schema = _schema(ct)
    lines = _valid_lines(tmp_path)
    assert ct.check_stream(lines, schema) == []

    bad = json.loads(lines[1])
    bad["totally_new_metric"] = 1.0
    errs = ct.check_stream([lines[0], json.dumps(bad)], schema)
    assert any("unknown" in e for e in errs)

    bad = json.loads(lines[1])
    del bad["loss"]
    errs = ct.check_stream([lines[0], json.dumps(bad)], schema)
    assert any("missing" in e for e in errs)

    errs = ct.check_stream([lines[0], lines[2], lines[1]], schema)
    assert any("monotone" in e for e in errs)

    errs = ct.check_stream([lines[1]], schema)
    assert any("before any manifest" in e for e in errs)


def test_obs6_csv_sink(tmp_path):
    run_dir = str(tmp_path / "run")
    tr = _trainer(tmp_path, sink="csv", run_dir=run_dir)
    tr.run(3, log=None)
    tr.close()
    path = os.path.join(run_dir, "run.csv")
    rows = list(csv.DictReader(open(path)))
    assert len(rows) == 3
    assert "loss" in rows[0]
    assert os.path.exists(path + ".manifest.json")


# ---------------------------------------------------------------------------
# OBS7: exception-safe tracing; the spans reach torch.profiler
# ---------------------------------------------------------------------------


def test_obs7_session_exports_trace_on_crash(tmp_path):
    tr = Tracer(enabled=True)
    path = str(tmp_path / "trace.json")
    with pytest.raises(RuntimeError, match="boom"):
        with tr.session(export_path=path):
            with tr.span("obs.dispatch"):
                pass
            with tr.span("phase.that.crashes"):
                raise RuntimeError("boom")
    events = json.load(open(path))["traceEvents"]
    names = [e["name"] for e in events]
    assert "obs.dispatch" in names and "phase.that.crashes" in names
    assert all(e["dur"] >= 0 for e in events)
    assert tr._open == []


def test_obs7_close_open_spans_finalizes_orphans():
    tr = Tracer(enabled=True)
    cm = tr.span("orphan")
    cm.__enter__()
    assert len(tr._open) == 1
    closed = tr.close_open_spans()
    assert closed == ["orphan"]
    assert tr.interrupted == ["orphan"]
    assert [n for n, _, _ in tr.events] == ["orphan"]
    assert tr.close_open_spans() == []  # idempotent


def test_obs7_trainer_crash_still_writes_trace(tmp_path):
    run_dir = str(tmp_path / "run")
    tr = _trainer(tmp_path, sink="jsonl", run_dir=run_dir, trace=True)

    def bomb(*a, **k):
        raise KeyboardInterrupt

    tr.run(2, log=None)  # builds obs, records real spans
    tr.batch_fn = bomb
    with pytest.raises(KeyboardInterrupt):
        tr.run(2, log=None)
    tr.close()
    events = json.load(open(os.path.join(run_dir, "trace.json")))[
        "traceEvents"]
    assert any(e["name"] == "obs.dispatch" for e in events)


def test_obs7_spans_land_in_the_torch_trace(tmp_path):
    """Each span opens a ``torch.profiler.record_function`` of its name;
    with ``profiler`` on, the Trainer's torch trace holds the obs spans
    beside the meta step's own ``obs.local_phase`` / ``obs.meta_mix``."""
    run_dir = str(tmp_path / "run")
    tr = _trainer(tmp_path, sink="jsonl", run_dir=run_dir, trace=True,
                  profiler=True)
    tr.run(2, log=None)
    tr.close()
    files = os.listdir(os.path.join(run_dir, "torch_trace"))
    assert files
    events = json.load(open(os.path.join(run_dir, "torch_trace",
                                         files[0])))["traceEvents"]
    names = {e.get("name") for e in events}
    for span in ("obs.dispatch", "obs.host_flush", "obs.sink_append",
                 "obs.local_phase", "obs.meta_mix"):
        assert span in names, span
    summary = tr.tracer.summary()
    assert summary["obs.dispatch"]["count"] == 2


# ---------------------------------------------------------------------------
# OBS8: torn-tail repair on resume
# ---------------------------------------------------------------------------


def test_obs8_resume_truncates_torn_tail(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sink = JsonlSink(path)
    sink.open_run({"kind": "manifest", "schema_version": 2})
    sink.append({"kind": "step", "meta_step": 0, "loss": 1.0})
    sink.close()
    whole = open(path, "rb").read()
    torn = b'{"kind": "step", "meta_step": 1, "lo'
    with open(path, "wb") as f:
        f.write(whole + torn)

    sink2 = JsonlSink(path, resume=True)
    assert sink2.repaired_bytes == len(torn)
    sink2.open_run({"kind": "manifest", "schema_version": 2})
    sink2.append({"kind": "step", "meta_step": 1, "loss": 0.9})
    sink2.close()
    recs = [json.loads(line) for line in open(path)]
    assert [r["kind"] for r in recs] == ["manifest", "step", "manifest",
                                        "step"]
    assert recs[-1]["meta_step"] == 1


def test_obs8_repair_walks_back_over_corrupt_complete_lines(tmp_path):
    path = str(tmp_path / "run.jsonl")
    good = b'{"kind": "manifest"}\n{"kind": "step", "meta_step": 0}\n'
    with open(path, "wb") as f:
        f.write(good + b'garbage not json\n{"kind": "st')
    assert _repair_torn_tail(path) == len(b'garbage not json\n{"kind": "st')
    assert open(path, "rb").read() == good


def test_obs8_repair_noop_on_clean_and_empty_files(tmp_path):
    clean = tmp_path / "clean.jsonl"
    clean.write_text('{"kind": "manifest"}\n')
    assert _repair_torn_tail(str(clean)) == 0
    assert clean.read_text() == '{"kind": "manifest"}\n'
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert _repair_torn_tail(str(empty)) == 0


def test_obs8_jsonify_tensors_and_numpy_scalars():
    assert _jsonify(torch.tensor(2.5)) == 2.5
    assert _jsonify(np.float32(0.5)) == 0.5
    assert _jsonify(torch.tensor([1, 2])) == [1, 2]
    assert _jsonify(np.arange(2)) == [0, 1]
    line = json.dumps({"a": torch.tensor(1.0), "b": np.int64(3)},
                      default=_jsonify)
    assert json.loads(line) == {"a": 1.0, "b": 3}


# ---------------------------------------------------------------------------
# OBS9: schema versioning
# ---------------------------------------------------------------------------


def test_obs9_version_gate(tmp_path):
    ct = _check_telemetry()
    schema = _schema(ct)
    lines = _valid_lines(tmp_path)
    man = json.loads(lines[0])
    assert man["schema_version"] == schema["schema_version"]
    for v in schema["known_versions"]:
        man2 = dict(man, schema_version=v)
        assert ct.check_stream([json.dumps(man2)] + lines[1:], schema) == []
    man99 = dict(man, schema_version=99)
    errs = ct.check_stream([json.dumps(man99)] + lines[1:], schema)
    assert any("unknown major" in e for e in errs)
    man21 = dict(man, schema_version="2.1")
    assert ct.check_stream([json.dumps(man21)] + lines[1:], schema) == []


def test_obs9_alert_records_validate(tmp_path):
    ct = _check_telemetry()
    schema = _schema(ct)
    man = _valid_lines(tmp_path)[0]
    ok = {"kind": "alert", "rule": "nonfinite_loss", "metric": "loss",
          "value": None, "severity": "fatal", "halt": True, "meta_step": 3}
    assert ct.check_stream([man, json.dumps(ok)], schema) == []
    bad = dict(ok)
    del bad["rule"]
    assert ct.check_stream([man, json.dumps(bad)], schema)
    assert ct.check_stream(
        [man, json.dumps(dict(ok, severity="panic"))], schema)
    assert ct.check_stream([man, json.dumps(dict(ok, halt="yes"))], schema)
    assert ct.check_stream([json.dumps(ok)], schema)


# ---------------------------------------------------------------------------
# the manifest: the schema's environment keys, torch's identity
# ---------------------------------------------------------------------------


def test_manifest_environment_keys(tmp_path):
    ct = _check_telemetry()
    schema = _schema(ct)
    man = run_manifest(device="cpu")
    assert set(schema["manifest_required"]) <= set(man)
    assert man["jax_version"] is None and man["backend"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert man["device_count"] == 1 and man["process_index"] == 0
    json.dumps(man)


# ---------------------------------------------------------------------------
# the port against the JAX Trainer on the same inputs
# ---------------------------------------------------------------------------

PL = 2  # learners of the parity runs
JBATCH_FN = jclassif_batch_fn(D, C, PL, K, B)


def _jax_streams(seed=0):
    """JAX's Trainer stream split: (data_rng, init_rng)."""
    return jax.random.split(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _jparams():
    return jax.device_get(jmlp_init(_jax_streams()[1], D, H, C))


@functools.lru_cache(maxsize=None)
def _jbatch(step):
    data_rng = _jax_streams()[0]
    return jax.device_get(JBATCH_FN(jax.random.fold_in(data_rng, step),
                                    step))


def _pair_run(tmp_path, steps=4, log_every=2, **obs_kw):
    """The JAX and the port Trainer on one config and JAX's inputs; each
    writes its own run.jsonl. Returns the two run directories and the two
    Trainers (closed)."""
    kw = dict(algorithm="mavg", num_learners=PL, k_steps=K, learner_lr=0.1,
              momentum=0.6)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JTrainer(
        jbase.TrainConfig(model=None, mavg=jbase.MAvgConfig(**kw),
                          batch_per_learner=B, meta_steps=steps,
                          log_every=log_every,
                          obs=jbase.ObsConfig(sink="jsonl", run_dir=jdir,
                                              **obs_kw)),
        jmlp_loss, init_params_fn=lambda rng: jmlp_init(rng, D, H, C),
        batch_fn=JBATCH_FN)
    jt.run(steps, log=None)
    jt.close()
    tt = Trainer(
        TrainConfig(model=None, mavg=MAvgConfig(**kw), batch_per_learner=B,
                    meta_steps=steps, log_every=log_every,
                    obs=ObsConfig(sink="jsonl", run_dir=tdir, **obs_kw)),
        mlp_loss,
        init_params_fn=lambda gen: interop.params_from_jax(_jparams()),
        batch_fn=lambda gen, step: interop.params_from_jax(_jbatch(step)),
        device="cpu")
    tt.run(steps, log=None)
    tt.close()
    return jdir, tdir, jt, tt


def _records(run_dir):
    with open(os.path.join(run_dir, "run.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_step_records_have_jax_keys(tmp_path):
    """Repair: the port's step records carry exactly JAX's keys (no
    ``lr``), in the history as in the log."""
    _, _, jt, tt = _pair_run(tmp_path, steps=3, log_every=1)
    assert len(tt.history) == len(jt.history) == 3
    for jr, tr in zip(jt.history, tt.history):
        assert set(tr) == set(jr)
    assert "lr" not in tt.history[0]


def test_run_logs_match_jax(tmp_path):
    jdir, tdir, jt, tt = _pair_run(tmp_path, steps=4, log_every=2,
                                   health=True, trace=True)
    jrecs, trecs = _records(jdir), _records(tdir)
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    jman, tman = jrecs[0], trecs[0]
    assert set(jman) <= set(tman)
    for key in ("schema_version", "algorithm", "num_learners", "k_steps",
                "topology", "comm_scheme", "elastic", "packed", "donate"):
        assert tman[key] == jman[key], key
    assert tman["packspec_hash"] == jman["packspec_hash"]
    for jr, tr in zip(jrecs[1:], trecs[1:]):
        assert set(tr) == set(jr)
        for k, v in jr.items():
            if k in TIME_KEYS or k == "kind":
                continue
            np.testing.assert_allclose(tr[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    ct = _check_telemetry()
    schema = _schema(ct)
    for d in (jdir, tdir):
        with open(os.path.join(d, "run.jsonl")) as f:
            assert ct.check_stream(f, schema) == [], d
        assert os.path.exists(os.path.join(d, "trace.json"))
    assert tt._mb.host_syncs == jt._mb.host_syncs == 2


def test_obs_config_honoured_and_cost_analysis_refused(tmp_path):
    """Repair: ``TrainConfig.obs`` is read (the sink is written, the
    watchdog built); a knob the port cannot honour raises."""
    tr = _trainer(tmp_path, sink="jsonl", health=True)
    tr.run(2, log=None)
    tr.close()
    assert tr._monitor is not None
    assert os.path.exists(tmp_path / "run" / "run.jsonl")
    with pytest.raises(NotImplementedError, match="item 10"):
        _trainer(tmp_path, sink="memory", cost_analysis=True)


def test_packspec_hash_equals_jax():
    """The manifest's layout hash is JAX's for the same tree: the MLP and
    full-width Qwen3-1.7B (shapes only on both sides)."""
    jspec = jmake_pack_spec(_jparams())
    tspec = make_pack_spec(interop.params_from_jax(_jparams()))
    assert packspec_hash(tspec) == jpackspec_hash(jspec)
    jcfg = jbase.get_config("qwen3-1.7b")
    jshapes = jax.eval_shape(lambda k: japi.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tparams = api.init_params(None, tbase.get_config("qwen3-1.7b"), "meta")
    h = packspec_hash(make_pack_spec(tparams))
    assert h == jpackspec_hash(jmake_pack_spec(jshapes))
    assert packspec_hash(None) is None and len(h) == 16


# ---------------------------------------------------------------------------
# the launcher's telemetry flags
# ---------------------------------------------------------------------------


def test_launcher_writes_a_valid_run_log(tmp_path, capsys):
    run_dir = tmp_path / "run"
    launch_train.main(["--device", "cpu", "--learners", "2", "--k", "2",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--obs-sink", "jsonl", "--run-dir", str(run_dir),
                       "--trace", "--obs-health"])
    assert "final train loss" in capsys.readouterr().out
    ct = _check_telemetry()
    assert ct.check_file(str(run_dir / "run.jsonl"), _schema(ct)) == []
    recs = [json.loads(line) for line in open(run_dir / "run.jsonl")]
    assert [r["meta_step"] for r in recs if r["kind"] == "step"] == [
        0, 1, 2, 3]
    assert all(math.isfinite(r["loss"]) for r in recs
               if r["kind"] == "step")
    events = json.load(open(run_dir / "trace.json"))["traceEvents"]
    assert {"obs.dispatch", "obs.host_flush"} <= {e["name"] for e in events}


@pytest.mark.parametrize("argv,message", [
    (["--supervise"], "--supervise needs --checkpoint-dir (the verified "
                      "rollback chain lives there)"),
    (["--obs-cost"], "ROADMAP Queue 1, item 10"),
], ids=["supervise-without-checkpoint-dir", "obs-cost"])
def test_launcher_refusals(argv, message):
    with pytest.raises(SystemExit) as ei:
        launch_train.main(["--device", "cpu", "--steps", "1"] + argv)
    assert message in str(ei.value)
