"""The robust and comm benches, the wire-byte model and the suite runner
on the port, against the JAX package's on the same inputs.

* ``roofline``: every modeled cell of the comm, topology, elastic and
  async benches (qwen3-1.7b's parameter count) gives exactly JAX's bytes,
  degree and presence, and its link seconds are those bytes at the H100
  data sheet's link rates, in JAX's form.
* the robust bench, fed JAX's Trainer params and batches: its arms'
  losses within rtol 1e-5 of JAX's (the robust arm's clip factors come
  from norms each package reduces in its own order: rtol 1e-4; the
  corrupted plain mean, 190x the bar, within 5 %), and the six bars of
  ``benchmarks/expected/robust.json`` with ``rollbacks == 0`` under the
  port's Supervisor; ``loss_vs_fault_free`` 1.031.
* the comm bench, fed JAX's params, batches and dither: the reducers'
  wire bytes and compression equal to JAX's; dense and topk losses within
  rtol 1e-5 and accuracy within one of 2,048 evaluation examples. A
  stochastic-rounding decision flips where the two packages' gradients
  differ in the last bits, moves its value by one quantum, and the flips
  compound over the 15 meta steps, so each compressed scheme's losses are
  held to a limit set from its measured gap on the CPU (int8 1.8e-5,
  fp8 1.4e-4, int8_topk 1.0e-3: limits 6e-5, 5e-4, 2e-3) and two
  examples. Its first meta step is held to PERF.md section 2's
  compressed rule (at most 0.5 % of meta params, momentum and residual
  beyond rtol 1e-5 / atol 1e-6, each within 2 quanta; measured: none
  beyond, max |diff| 6e-8), and the rule refuses the port's dense step
  and its int8 step on its own dither in place of JAX's (95.1 % and
  47.1 % of the values beyond).
* ``tools/bench_compare.py`` (the reference's gate, as a subprocess)
  accepts the port's ``BENCH_robust.json`` and the ``--json`` envelopes.
* ``run.py``: the roofline suite tabulates the dry run's rows; a default
  run skips no suite; a table-returning suite gets no store (the
  reference's own run fails there, pinned below).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import async_bench as jasync_bench  # noqa: E402
from benchmarks import comm_bench as jcomm_bench  # noqa: E402
from benchmarks import elastic_bench as jelastic_bench  # noqa: E402
from benchmarks import robust_bench as jrobust_bench  # noqa: E402
from benchmarks import topology_bench as jtopology_bench  # noqa: E402
from benchmarks.common import run_mlp as jrun_mlp  # noqa: E402
from repro import roofline as jroofline  # noqa: E402
from repro.comm import QuantReducer as JQuantReducer  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop, roofline  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    async_bench,
    chaos_bench,
    comm_bench,
    elastic_bench,
    robust_bench,
    run,
    topology_bench,
)
from repro_torch.configs import base as tbase  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_EXAMPLE = 1 / 2048 + 1e-9


def jax_inputs(P, K, batch, steps, seed=0):
    """``run_mlp`` overrides carrying JAX's ``run_mlp`` draws."""
    params = jax.device_get(mlp_init(jax.random.PRNGKey(seed), 32, 64, 10))
    bf = classif_batch_fn(32, 10, P, K, batch)
    key = jax.random.PRNGKey(seed + 1)
    batches = [interop.params_from_jax(jax.device_get(
        bf(jax.random.fold_in(key, i), i))) for i in range(steps)]
    ev = jax.device_get(classif_eval_set(32, 10))
    return dict(params=interop.params_from_jax(params),
                batch_at=batches.__getitem__,
                eval_set=interop.params_from_jax(ev))


def jax_dither(seed=0):
    red = JQuantReducer(seed=seed)
    return interop.dither_from_numpy(
        lambda i, step, shape: np.asarray(
            jax.random.uniform(red._leaf_key(i, step), shape, jnp.float32)))


def gate(*paths):
    return subprocess.run([sys.executable, "tools/bench_compare.py", *paths],
                          cwd=ROOT, capture_output=True, text=True)


# ---------------------------------------------------------------------------
# the wire-byte model
# ---------------------------------------------------------------------------

def _to_port(cfg):
    """A JAX TopologyConfig / CommConfig / ElasticConfig / AsyncConfig as
    the port's, field for field."""
    if cfg is None or isinstance(cfg, (int, float, str, bool, tuple)):
        return cfg
    cls = getattr(tbase, type(cfg).__name__)
    return cls(**{f: _to_port(getattr(cfg, f))
                  for f in cfg.__dataclass_fields__})


def _modeled_cells():
    yield from ((n, c, t) for n, t, c in jtopology_bench.CELLS)
    yield from ((n, jbase.CommConfig(), t)
                for n, t in jelastic_bench.MODEL_CELLS)
    yield from ((n, jbase.CommConfig(), t) for n, t in (
        ("async_uniform", jbase.TopologyConfig(
            kind="async", server=jbase.AsyncConfig())),
        ("async_skew4", jbase.TopologyConfig(kind="async",
                                             server=jbase.AsyncConfig(
                                                 staleness=jasync_bench.TAU,
                                                 step_time=jasync_bench
                                                 .PROFILE)))))


@pytest.mark.parametrize("name,comm,topo", list(_modeled_cells()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_topology_wire_bytes_equal_jax(name, comm, topo):
    n = jbase.get_config("qwen3-1.7b").param_count()
    assert tbase.get_config("qwen3-1.7b").param_count() == n
    want = jroofline.topology_wire_bytes(n, comm, topo, num_learners=8)
    got = roofline.topology_wire_bytes(n, _to_port(comm), _to_port(topo),
                                       num_learners=8)
    assert got == want, name


@pytest.mark.parametrize("scheme", comm_bench.SCHEMES)
def test_meta_wire_bytes_equal_jax(scheme):
    n = jbase.get_config("qwen3-1.7b").param_count()
    want = jroofline.meta_wire_bytes(n, jcomm_bench._comm(scheme),
                                     num_learners=8)
    assert roofline.meta_wire_bytes(n, comm_bench._comm(scheme),
                                    num_learners=8) == want
    row = next(r for r in comm_bench.modeled() if r["scheme"] == scheme)
    assert (row["dense_bytes"], row["wire_bytes"]) == want
    if scheme == "dense":
        assert f"{want[1]:.3e}" == "5.505e+10"


def test_modeled_rows_carry_no_link_seconds(capsys):
    """No TPU link seconds: every modeled row prices its bytes at the H100
    data sheet's link rates, in JAX's form (comm: the wire over the
    intra-node link; the others: intra over intra plus inter over
    inter), and each bench says so."""
    rates = roofline.H100_SXM
    rows = (comm_bench.modeled() + topology_bench.modeled()
            + elastic_bench.modeled() + async_bench.modeled())
    for r in rows:
        if r["kind"] == "comm_model":
            assert r["wire_s"] == r["wire_bytes"] / rates.intra_link_bytes_per_s
        elif r["kind"] != "topo_accept":
            assert r["wire_s"] == (
                r["intra_bytes"] / rates.intra_link_bytes_per_s
                + r["inter_bytes"] / rates.inter_link_bytes_per_s), r
    out = capsys.readouterr().out
    assert out.count("inputs, not measured") == 4
    assert out.count("450 GB/s (NVLink 4), inter-node 50 GB/s") == 4
    flat = next(r for r in rows if r.get("cell") == "flat_dense"
                and r["kind"] == "topo_model")
    assert f"{flat['wire_s']:.4f}" == "1.1011"
    accept = next(r for r in rows if r["kind"] == "topo_accept")
    assert f"{accept['inter_reduction_vs_flat']:.1f}" == "63.9"
    hier = next(r for r in rows if r.get("cell") == "hier_int8topk_outer")
    assert hier["inter_bytes"] == 861065600.0000001
    skew = next(r for r in rows if r.get("cell") == "async_skew4")
    assert skew["inter_bytes"] == 37849923584.0


def test_unknown_scheme_and_topology_raise():
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="unknown comm scheme"):
        roofline.participant_wire_bytes(
            10, SimpleNamespace(scheme="int2", chunk_rows=64))
    with pytest.raises(ValueError, match="unknown topology"):
        roofline.topology_wire_bytes(
            10, None, SimpleNamespace(kind="ring", elastic=None),
            num_learners=2)


# ---------------------------------------------------------------------------
# the robust bench
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def robust_runs(tmp_path_factory):
    data_rng, init_rng = jax.random.split(jax.random.PRNGKey(0))
    bf = classif_batch_fn(32, 10, robust_bench.P, robust_bench.K,
                          robust_bench.BATCH)
    params = interop.params_from_jax(jax.device_get(
        mlp_init(init_rng, 32, 64, 10)))
    cache = {}

    def batch_at(step):
        if step not in cache:
            cache[step] = interop.params_from_jax(jax.device_get(
                bf(jax.random.fold_in(data_rng, step), step)))
        return cache[step]

    out = tmp_path_factory.mktemp("robust")
    envelope = str(out / "robust_bench.json")
    rows = robust_bench.main(quick=True, json_path=envelope, device="cpu",
                             params=params, batch_at=batch_at)
    return rows, jrobust_bench.measured(True), envelope, out


def test_robust_settings_are_the_references():
    assert (robust_bench.P, robust_bench.K, robust_bench.MU, robust_bench.LR,
            robust_bench.BATCH, robust_bench.BAD) == (
        jrobust_bench.P, jrobust_bench.K, jrobust_bench.MU, jrobust_bench.LR,
        jrobust_bench.BATCH, jrobust_bench.BAD)
    assert _to_port(jrobust_bench.ROBUST) == robust_bench.ROBUST
    assert _to_port(jrobust_bench.INERT) == robust_bench.INERT


def test_robust_bench_fed_jax_inputs_matches_jax(robust_runs):
    rows, jrows, _, _ = robust_runs
    assert [r.get("cell") for r in rows] == [r.get("cell") for r in jrows]
    cells = {r.get("cell"): r for r in rows}
    jcells = {r.get("cell"): r for r in jrows}
    np.testing.assert_allclose(cells["fault_free"]["final_loss"],
                               jcells["fault_free"]["final_loss"], rtol=1e-5)
    np.testing.assert_allclose(cells["corrupt_robust"]["final_loss"],
                               jcells["corrupt_robust"]["final_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(cells["corrupt_mean"]["final_loss"],
                               jcells["corrupt_mean"]["final_loss"],
                               rtol=5e-2)
    for c in ("fault_free", "corrupt_mean", "corrupt_robust"):
        assert (cells[c]["effective_samples"]
                == jcells[c]["effective_samples"] == 4096)
    assert cells["corrupt_robust"]["robust_records"] == 16


def test_robust_bench_holds_its_six_bars_under_the_supervisor(robust_runs):
    rows, jrows, _, _ = robust_runs
    accept, jaccept = rows[-1], jrows[-1]
    assert accept["kind"] == "robust_accept"
    assert abs(accept["loss_vs_fault_free"] - 1.031) <= 1e-3
    np.testing.assert_allclose(accept["loss_vs_fault_free"],
                               jaccept["loss_vs_fault_free"], rtol=1e-4)
    assert accept["loss_vs_fault_free"] <= 1.05
    assert accept["mean_degrades"] and accept["state_finite"]
    assert accept["rollbacks"] == 0
    assert accept["bitwise_off"] and accept["anomalous_is_corrupt_learner"]
    assert accept["ok"]
    assert set(accept) == set(jaccept)


def test_bench_compare_accepts_the_ports_robust_rows(robust_runs):
    rows, _, envelope, out = robust_runs
    path = run.store(str(out / "bench"), "robust", rows)
    assert os.path.basename(path) == "BENCH_robust.json"
    for p in (path, envelope):
        res = gate(p)
        assert res.returncode == 0, res.stderr
        assert "ok: robust" in res.stdout and "6 metric(s)" in res.stdout
    first = json.loads(open(envelope).readline())
    assert first["kind"] == "manifest" and first["suite"] == "robust"
    assert first["jax_version"] is None


def test_bench_compare_refuses_a_failed_robust_bar(robust_runs, tmp_path):
    rows = [dict(r) for r in robust_runs[0]]
    rows[-1]["rollbacks"] = 1
    res = gate(run.store(str(tmp_path), "robust", rows))
    assert res.returncode == 1 and "rollbacks" in res.stderr


# ---------------------------------------------------------------------------
# the comm bench
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def comm_rows():
    return comm_bench.measured(True, device="cpu", dither=jax_dither(),
                               **jax_inputs(4, 4, 16, 15))


@pytest.mark.parametrize("scheme", comm_bench.SCHEMES)
def test_comm_bench_fed_jax_inputs_matches_jax(comm_rows, scheme):
    row = next(r for r in comm_rows if r["scheme"] == scheme)
    comm = jcomm_bench._comm(scheme)
    jlosses, jacc = jrun_mlp("mavg", P=4, K=4, mu=0.7, steps=15, comm=comm)
    # the reducer's own bytes of one JAX meta step on the same config
    cfg = jbase.MAvgConfig(algorithm="mavg", num_learners=4, k_steps=4,
                           learner_lr=0.2, momentum=0.7, comm=comm)
    from repro.core.meta import init_state, make_meta_step
    from repro.models.simple import mlp_loss

    state = init_state(mlp_init(jax.random.PRNGKey(0), 32, 64, 10), cfg)
    b = classif_batch_fn(32, 10, 4, 4, 16)(jax.random.PRNGKey(1), 0)
    _, m = jax.jit(make_meta_step(mlp_loss, cfg))(state, b)
    # JAX reports the bytes as f32 metrics
    assert np.float32(row["bytes_wire"]) == np.float32(m["comm_bytes"])
    np.testing.assert_allclose(
        row["compression"],
        float(m["comm_bytes_dense"]) / float(m["comm_bytes"]), rtol=1e-6)
    rtol, examples = COMM_LOSS_RTOL[scheme]
    np.testing.assert_allclose(row["losses"], jlosses, rtol=rtol)
    assert abs(row["val_acc"] - jacc) <= examples * ONE_EXAMPLE
    assert row["step_time_us"] > 0 and row["device"] == "cpu"


# (loss rtol, evaluation examples) of the 15-step runs, port against JAX
COMM_LOSS_RTOL = {"dense": (1e-5, 1), "topk": (1e-5, 1), "int8": (6e-5, 2),
                  "fp8": (5e-4, 2), "int8_topk": (2e-3, 2)}
# PERF.md section 2's compressed rule: at most this share of the values
# beyond rtol 1e-5 / atol 1e-6, each within this many quanta
FLIP_SHARE, FLIP_QUANTA = 0.005, 2


def _one_comm_step(scheme, port_scheme=None, dither=None):
    """One meta step of the comm bench's config from JAX's params, batch 0
    and dither in both packages (the port's on ``port_scheme`` and
    ``dither`` where given): (port values, JAX values, JAX residual), the
    values being meta params, momentum and residual, flattened."""
    from repro.core.meta import init_state, make_meta_step
    from repro.models.simple import mlp_loss as jmlp_loss
    from repro_torch.benchmarks.common import train_curve
    from repro_torch.models.simple import mlp_loss
    from repro_torch.pack import unpack_params
    from repro_torch.utils.tree import tree_leaves

    cfg = jbase.MAvgConfig(algorithm="mavg", num_learners=4, k_steps=4,
                           learner_lr=0.2, momentum=0.7,
                           comm=jcomm_bench._comm(scheme))
    state = init_state(mlp_init(jax.random.PRNGKey(0), 32, 64, 10), cfg)
    b = classif_batch_fn(32, 10, 4, 4, 16)(
        jax.random.fold_in(jax.random.PRNGKey(1), 0), 0)
    state, _ = jax.jit(make_meta_step(jmlp_loss, cfg))(state, b)
    state = jax.device_get(state)
    tcfg = tbase.MAvgConfig(algorithm="mavg", num_learners=4, k_steps=4,
                            learner_lr=0.2, momentum=0.7,
                            comm=comm_bench._comm(port_scheme or scheme))
    inp = jax_inputs(4, 4, 16, 1)
    _, tstate = train_curve(mlp_loss, tcfg, inp["params"], inp["batch_at"],
                            1, dither or jax_dither())

    def flat(*trees):
        return np.concatenate([np.asarray(x, np.float32).ravel()
                               for t in trees for x in t])

    from repro.pack import unpack_params as junpack
    jres = flat(jax.tree.leaves(state.comm_residual))
    want = flat(jax.tree.leaves(junpack(state)),
                jax.tree.leaves(state.momentum), jres)
    tres = ([x.numpy() for x in tree_leaves(tstate.comm_residual)]
            if tstate.comm_residual is not None else [np.zeros_like(jres)])
    got = flat([x.numpy() for x in tree_leaves(unpack_params(tstate))],
               [x.numpy() for x in tree_leaves(tstate.momentum)], tres)
    return got, want, jres


def _flip_rule(got, want, jres):
    """(holds, share beyond rtol 1e-5 / atol 1e-6, max |diff| in quanta).
    The quantum is the JAX residual's largest |value|: each value's
    rounding error lies within one quantum of its chunk, so this is at
    most the largest quantum (for top-k the residual also holds the unsent
    values, the largest of which stands for the one kept value that may
    cross the threshold)."""
    diff = np.abs(got - want)
    share = float((diff > 1e-6 + 1e-5 * np.abs(want)).mean())
    quanta = float(diff.max() / np.abs(jres).max())
    return (share <= FLIP_SHARE and quanta <= FLIP_QUANTA), share, quanta


@pytest.mark.parametrize("scheme", ["int8", "fp8", "int8_topk"])
def test_comm_bench_first_step_holds_the_compressed_rule(scheme):
    ok, share, quanta = _flip_rule(*_one_comm_step(scheme))
    assert ok, (share, quanta)


@pytest.mark.parametrize("fault", ["dense", "own_dither"])
def test_comm_compressed_rule_refuses_a_planted_fault(fault):
    from repro_torch.comm import seeded_dither

    got, want, jres = _one_comm_step(
        "int8", port_scheme="dense" if fault == "dense" else None,
        dither=seeded_dither(0) if fault == "own_dither" else None)
    ok, share, _ = _flip_rule(got, want, jres)
    assert not ok and share > 0.1, share


def test_comm_bench_compression_is_the_references(comm_rows):
    got = {r["scheme"]: round(r["compression"], 2) for r in comm_rows}
    assert got["int8"] == 4.00 and got["int8_topk"] == 7.98
    assert got["dense"] == 1.0


# ---------------------------------------------------------------------------
# the --json envelopes of the async and chaos benches
# ---------------------------------------------------------------------------

def test_async_and_chaos_write_gated_envelopes(monkeypatch, tmp_path):
    accept = {"kind": "async_accept", "staleness_max": 3.0,
              "loss_vs_sync_at_equal_samples": 0.98, "sync_idle_frac": 0.5,
              "wall_clock_speedup": 2.6}
    monkeypatch.setattr(async_bench, "measured", lambda q, d: [accept])
    path = str(tmp_path / "async_bench.json")
    rows = async_bench.main(quick=True, device="cpu", json_path=path)
    assert [r["kind"] for r in rows] == ["async_accept"] + 3 * ["async_model"]
    res = gate(path)
    assert res.returncode == 0 and "ok: async" in res.stdout, res.stderr

    chaos = {"kind": "chaos_accept", "loss_vs_fault_free": 1.02,
             "state_finite": True, "bitwise_off": True,
             "resume_verified": True, "retries_used": 1, "ok": True}
    monkeypatch.setattr(chaos_bench, "measured", lambda q, d, w: [chaos])
    path = str(tmp_path / "chaos_bench.json")
    chaos_bench.main(quick=True, device="cpu", json_path=path)
    recs = [json.loads(ln) for ln in open(path)]
    assert recs[0]["suite"] == "chaos"
    assert recs[1]["row_kind"] == "chaos_accept" and recs[1]["kind"] == "row"
    res = gate(path)
    assert res.returncode == 0 and "ok: chaos" in res.stdout, res.stderr


# ---------------------------------------------------------------------------
# the suite runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suite", ["roofline"])
def test_run_only_an_item_10_suite_raises(suite, monkeypatch, capsys,
                                          tmp_path):
    """The suite of the former item 10 (the dry run) runs now: it
    tabulates the dry run's rows and stores none (a table, as JAX's)."""
    from repro_torch.benchmarks import roofline_table

    row = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single",
           "mode": "faithful", "algorithm": "mavg", "skipped": True,
           "reason": "a stand-in row"}
    (tmp_path / "row.json").write_text(json.dumps(row))
    monkeypatch.setattr(roofline_table, "RESULTS", str(tmp_path))
    run.main(["--only", suite, "--device", "cpu", "--bench-dir",
              str(tmp_path / "store")])
    out = capsys.readouterr().out
    assert "| qwen3-1.7b | train_4k | single | SKIP: a stand-in row" in out
    assert f"bench,{suite},trajectory,none (a table, no rows)" in out
    assert not hasattr(run, "NOT_PORTED")


def test_run_default_names_the_suites_it_does_not_run(monkeypatch, capsys,
                                                      tmp_path):
    monkeypatch.setattr(run, "suites", lambda quick, device: {
        "robust": lambda: [{"kind": "robust_accept", "ok": True, "x": 1}],
        "mu_p": lambda: ({(2, 0.0): 0.5}, {2: 0.0}),
        "bad": lambda: [{"kind": "cell", "ok": False}],
    })
    with pytest.raises(SystemExit, match="bad"):
        run.main(["--device", "cpu", "--bench-dir", str(tmp_path)])
    out = capsys.readouterr().out
    for s in ("roofline", "kernel", "pack"):
        assert f"bench,{s},not run" not in out
    assert "bench,mu_p,trajectory,none (a table, no rows)" in out
    assert "bench,bad," in out and "FAILED (1 cell(s) not ok)" in out
    assert sorted(os.listdir(tmp_path)) == ["BENCH_robust.json"]
    point = json.loads(open(tmp_path / "BENCH_robust.json").readline())
    assert point["rows"] == [{"kind": "row", "row_kind": "robust_accept",
                              "ok": True, "x": 1}]
    assert run.DEFAULT_BENCH_DIR.startswith("build/")


def test_run_suite_names_are_the_references():
    import inspect

    from benchmarks import run as jrun

    src = inspect.getsource(jrun.main)
    names = set(run.suites(True, "cpu"))
    for name in names:
        assert f'"{name}": ' in src, name
    assert len(names) == src.count('": lambda') + src.count(
        '"roofline": roofline_table.main')


def test_reference_run_fails_the_e2_and_e3_stores(monkeypatch, tmp_path,
                                                 capsys):
    """The departure ``run.py`` documents: the reference appends E2's and
    E3's returned tables as rows and fails both suites in ``json.dumps``."""
    from benchmarks import k_sweep, mu_p_sweep
    from benchmarks import run as jrun

    monkeypatch.setattr(mu_p_sweep, "main",
                        lambda quick: ({(2, 0.0): 0.5}, {2: 0.0}))
    monkeypatch.setattr(k_sweep, "main", lambda quick: ({1: 0.7}, {1: 0.7}))
    monkeypatch.setattr(sys, "argv", ["run", "--only", "mu_p", "k",
                                      "--bench-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="FAILED suites"):
        jrun.main()
    assert "not supported between instances" in capsys.readouterr().out
