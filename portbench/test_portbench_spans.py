"""The readers of the Trainer's spans, on the CPU: each gives its mean a
meta step on made-up spans and None without them, and a traced run of a
cell at a reduced size reads the Trainer's real Tracer (``obs.dispatch``
and ``obs.data``; no device span exists on the CPU)."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from benchlib import spec  # noqa: E402

BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
# each reader and the span it sums
READS = {
    "local.forward_ms": "obs.forward.device",
    "local.backward_ms": "obs.backward.device",
    "local.update_ms": "obs.update.device",
    "host.gc_ms": "obs.gc",
    "trainer.data_ms": "obs.data",
    "trainer.dispatch_ms": "obs.dispatch",
}
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=96, vocab_size=200, dtype="float32")
SEED = 2**31 + 91


def _spans():
    """Two meta steps of made-up spans: each reader's own name twice a
    step (1 and 3 ms, then 2 and 4 ms), and the names beside it."""
    out = []
    for step, (a, b) in enumerate(((1e-3, 3e-3), (2e-3, 4e-3))):
        t = 1.8e9 + step
        for name in READS.values():
            out += [(name, t, a), (name, t + 0.1, b)]
        out += [("obs.local_phase", t, 1.0), ("obs.forward", t, 0.5),
                ("obs.local_phase.device", t, 1.0)]
    return out


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_gives_its_mean_a_step(metric):
    read = spec.metric_reader(metric, BENCH)
    ctx = SimpleNamespace(spans=_spans(), steps=2)
    # (1 + 3 + 2 + 4) ms over 2 steps; ``trainer.dispatch_ms`` is a mean a
    # span, which the Trainer records once a step
    want = 2.5 if metric == "trainer.dispatch_ms" else 5.0
    assert read(ctx) == pytest.approx(want)
    for spans in (None, [], [s for s in _spans() if s[0] != READS[metric]]):
        assert read(SimpleNamespace(spans=spans, steps=2)) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_the_new_metrics_are_listed_for_every_cell(metric):
    m = {x["name"]: x for x in BENCHMARK["per_layer"]}[metric]
    assert m["moves"] == "train_tokens_per_s"
    assert m["workloads"] == CELLS
    if metric != "trainer.dispatch_ms":
        assert m["source"] == "program_span" and m["unit"] == "ms"


def test_a_traced_run_reads_the_trainers_own_spans():
    """A traced run of the dense cell on the CPU: the unchanged
    ``trainer.dispatch_ms`` reader and ``trainer.data_ms`` read the
    Trainer's Tracer; the device readers find nothing on the CPU."""
    run_spec = importlib.util.spec_from_file_location("portbench_run_spans",
                                                      BENCH / "run.py")
    run = importlib.util.module_from_spec(run_spec)
    run_spec.loader.exec_module(run)
    plan = spec.plan("qwen3-1.7b.mavg-k1")
    plan.config["model"].update(SMALL)
    plan.traffic.update(learners=2, batch=4, seq_len=16)
    result = run.run_cell(plan, SEED, 0.05, trace=True, device="cpu")
    metrics = result["metrics"]
    assert result["correct"], result["compared"]
    for name in ("trainer.dispatch_ms", "trainer.data_ms"):
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] > 0
    for name in ("local.forward_ms", "local.backward_ms", "local.update_ms",
                 "meta.local_ms", "device.busy_ms"):
        assert name not in metrics, name
