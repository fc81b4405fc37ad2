"""The topology and elastic benches on the port, fed the JAX runners'
inputs (their params, batches, evaluation set and, for the compressed
cells, JAX's stochastic-rounding dither), against the JAX benches.

* topology: each of the six cells' final loss within rtol 1e-5 of JAX's
  (the int8 cells within 5e-5: a rounding decision flips where the two
  packages' gradients differ in the last bits, and moves its value by one
  quantum), the same accuracy within one of 2,048 evaluation examples,
  hier_int8topk_outer at 1.053x flat, and the modeled rows equal to JAX's:
  ``inter_reduction_vs_flat`` 63.9, hier_int8topk_outer's inter bytes
  8.611e8. ``tools/bench_compare.py`` accepts the port's
  ``BENCH_topology.json``; the gate's fixed-seed flat_dense baseline
  (0.713 +-15 %) is a value of JAX's stream, and the port fed that stream
  lands at JAX's 0.6611.
* elastic: the churn and hetero-K cells within rtol 1e-5 of JAX's and
  hier_drop25 at JAX's 1.016x static.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import elastic_bench as jelastic_bench  # noqa: E402
from benchmarks import topology_bench as jtopology_bench  # noqa: E402
from repro.comm import QuantReducer as JQuantReducer  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import elastic_bench, run  # noqa: E402
from repro_torch.benchmarks import topology_bench  # noqa: E402
from repro_torch.roofline import wire_seconds  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_EXAMPLE = 1 / 2048 + 1e-9
STEPS = 20  # quick mode, both benches


@pytest.fixture(scope="module")
def jax_inputs():
    params = jax.device_get(mlp_init(jax.random.PRNGKey(0), 32, 64, 10))
    bf = classif_batch_fn(32, 10, 8, 4, 16)
    key = jax.random.PRNGKey(1)
    batches = [interop.params_from_jax(jax.device_get(
        bf(jax.random.fold_in(key, i), i))) for i in range(STEPS)]
    ev = jax.device_get(classif_eval_set(32, 10))
    return dict(params=interop.params_from_jax(params),
                batch_at=batches.__getitem__,
                eval_set=interop.params_from_jax(ev))


def jax_dither(seed=0):
    red = JQuantReducer(seed=seed)
    return interop.dither_from_numpy(
        lambda i, step, shape: np.asarray(
            jax.random.uniform(red._leaf_key(i, step), shape, jnp.float32)))


def test_cells_are_the_references():
    assert [c[0] for c in topology_bench.CELLS] == [
        c[0] for c in jtopology_bench.CELLS]
    assert (topology_bench.P, topology_bench.K, topology_bench.MU) == (
        jtopology_bench.P, jtopology_bench.K, jtopology_bench.MU)
    for mine, ref in ((elastic_bench.CHURN_CELLS, jelastic_bench.CHURN_CELLS),
                      (elastic_bench.HETERO_K_CELLS,
                       jelastic_bench.HETERO_K_CELLS),
                      (elastic_bench.MODEL_CELLS, jelastic_bench.MODEL_CELLS)):
        assert [c[0] for c in mine] == [c[0] for c in ref]
        assert [c[-1] for c in mine if isinstance(c[-1], (str, tuple))] == [
            c[-1] for c in ref if isinstance(c[-1], (str, tuple))]


@pytest.fixture(scope="module")
def topology_runs(jax_inputs, tmp_path_factory):
    rows = topology_bench.main(quick=True, device="cpu",
                               dither=jax_dither(), **jax_inputs)
    return rows, jtopology_bench.main(quick=True), tmp_path_factory.mktemp(
        "topo")


def test_topology_bench_fed_jax_inputs_matches_jax(topology_runs):
    rows, jrows, _ = topology_runs
    assert [r["kind"] for r in rows] == [r["kind"] for r in jrows]
    for r, j in zip(rows, jrows):
        if r["kind"] == "topo_measured":
            assert r["cell"] == j["cell"]
            rtol = 5e-5 if "int8" in r["cell"] else 1e-5
            np.testing.assert_allclose(r["final_loss"], j["final_loss"],
                                       rtol=rtol, err_msg=r["cell"])
            assert abs(r["val_acc"] - j["val_acc"]) <= ONE_EXAMPLE
        elif r["kind"] == "topo_model":
            # the bytes are JAX's; the seconds price them at the H100
            # data sheet's link rates, not JAX's TPU rates
            want = {k: v for k, v in j.items() if k != "wire_s"}
            assert {k: v for k, v in r.items() if k != "wire_s"} == want
            assert r["wire_s"] == wire_seconds(r["intra_bytes"],
                                               r["inter_bytes"])
        else:
            assert r == j
    cells = {r["cell"]: r for r in rows if r["kind"] == "topo_measured"}
    assert f"{cells['flat_dense']['final_loss']:.4f}" == "0.6611"
    assert f"{cells['hier_int8topk_outer']['vs_flat']:.3f}" == "1.053"


def test_topology_acceptance_bytes_are_the_references(topology_runs):
    rows = topology_runs[0]
    accept = next(r for r in rows if r["kind"] == "topo_accept")
    assert f"{accept['inter_reduction_vs_flat']:.1f}" == "63.9"
    hier = next(r for r in rows if r["kind"] == "topo_model"
                and r["cell"] == "hier_int8topk_outer")
    assert hier["inter_bytes"] == 861065600.0000001


def test_bench_compare_accepts_the_ports_topology_store(topology_runs):
    rows, _, out = topology_runs
    path = run.store(str(out), "topology", rows)
    res = subprocess.run([sys.executable, "tools/bench_compare.py", path],
                         cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert "ok: topology" in res.stdout and "4 metric(s)" in res.stdout


def test_elastic_bench_fed_jax_inputs_matches_jax(jax_inputs):
    rows = elastic_bench.main(quick=True, device="cpu", **jax_inputs)
    jrows = (jelastic_bench.measured_churn(True)
             + jelastic_bench.measured_hetero_k(True))
    assert [r["kind"] for r in rows[:len(jrows)]] == [r["kind"]
                                                      for r in jrows]
    for r, j in zip(rows, jrows):
        if "final_loss" in r:
            assert r["cell"] == j["cell"]
            np.testing.assert_allclose(r["final_loss"], j["final_loss"],
                                       rtol=1e-5, err_msg=r["cell"])
            assert abs(r["val_acc"] - j["val_acc"]) <= ONE_EXAMPLE
            assert r.get("samples") == j.get("samples")
    accept = next(r for r in rows if r["kind"] == "elastic_accept")
    assert f"{accept['loss_vs_static_at_25pct_churn']:.3f}" == "1.016"
    assert accept["within_5pct"]
    models = [r for r in rows if r["kind"] == "elastic_model"]
    assert [r["cell"] for r in models] == [c[0] for c in
                                           jelastic_bench.MODEL_CELLS]
    deg = {r["cell"]: r["avg_degree"] for r in models}
    assert deg["gossip_one_peer"] == 1.0 and deg["gossip_exponential"] == 5.0
