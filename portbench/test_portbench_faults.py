"""The comparison fails what it must, on the CPU at a reduced size: a run
of each cell driven past the look for a card with the timed path broken
underneath (a meta step that returns its state unchanged; half of each
batch left out, the mean taken over the rest) comes out not correct, and
so does the control (the reference with bfloat16 learner planes in the
program's place), under each cell's own limits. A sound run comes out
correct. Also the reduction of a profiler trace, on made-up events."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from benchlib import compare, profile, ref_mavg, spec  # noqa: E402

CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {
    "dense": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=96, vocab_size=200),
    "moe": dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                head_dim=16, d_ff=96, vocab_size=200, num_experts=8,
                d_expert=24, moe_top_k=2, num_shared_experts=2),
}
SEED = 2**31 + 77


def _run_module():
    spec_ = importlib.util.spec_from_file_location("portbench_run",
                                                   BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def small_plan(cell: str):
    """The cell at a size the CPU holds, its model computing in float32
    (in bfloat16 the losses of a model this small round apart by more
    than the full-width cell's limit allows)."""
    p = spec.plan(cell)
    p.config["model"].update(SMALL[p.config["model"]["family"]],
                             dtype="float32")
    p.traffic.update(learners=2, batch=4, seq_len=16,
                     k_steps=min(p.traffic["k_steps"], 2))
    return p


@pytest.mark.parametrize("variant", ["program", "unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_only_when_the_timed_path_is_sound(cell, variant):
    run = _run_module()
    result = run.run_cell(small_plan(cell), SEED, 0.05, trace=False,
                          device="cpu", variant=variant)
    assert result["correct"] is (variant == "program"), result["compared"]
    assert list(result)[-2:] == ["compared", "lines"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell):
    p = small_plan(cell)
    cfg, traffic = p.config["model"], p.traffic
    steps = p.workload["ref_steps"]
    ref = ref_mavg.readings(cfg, traffic, SEED, steps, "cpu")
    control = ref_mavg.readings(cfg, traffic, SEED, steps, "cpu",
                                learner_dtype=torch.bfloat16)
    values = compare.numbers(control, ref)
    assert not compare.verdict(values, p.workload["limits"]), values


class Event:
    """The part of a profiler event (``_KinetoEvent``) the reduction
    reads."""

    def __init__(self, name, device, start, end, corr=0):
        self._v = (name, device, start, end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]


def test_a_trace_is_reduced_to_ranges_busy_time_and_gaps():
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        Event("obs.dispatch", CPU, 0, 1000),
        Event("obs.local_phase", CPU, 10, 600),
        Event("obs.meta_mix", CPU, 700, 900),
        Event("aten::mm", CPU, 20, 40),
        Event("cudaLaunchKernel", CPU, 25, 30, corr=1),
        Event("cudaLaunchKernel", CPU, 750, 760, corr=2),
        Event("gemm_kernel", CUDA, 100, 300, corr=1),
        Event("momentum_kernel", CUDA, 250, 400, corr=2),
        Event("obs.local_phase", CUDA, 100, 300),
    ]
    trace = profile.reduce_events(events, 1e-6, 0, 1000)
    assert [(op.name, op.range) for op in trace.ops] == [
        ("gemm_kernel", "obs.local_phase"), ("momentum_kernel",
                                             "obs.meta_mix")]
    assert trace.launches_matched == 2
    assert trace.busy_s == pytest.approx(300e-9)
    assert sorted(s for s, _ in trace.gaps) == pytest.approx(
        [100e-9, 600e-9])
    bd = trace.breakdown()
    assert bd["device_ops"][0][0] == "gemm_kernel"
    assert bd["idle_gaps"][0][0] == "obs.meta_mix no op"
    assert bd["idle_gaps"][0][1] == pytest.approx(600e-9)
