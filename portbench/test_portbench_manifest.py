"""The benchmark's files against its contract, on the CPU: names and
units, which cells report which metrics, cells found by name, a cell or
a metric added as files alone, the configurations against their sources,
the imports of a run, and no result without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import spec  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCHMARK["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCHMARK["workloads"]]
             + [w["traffic"] for w in BENCHMARK["workloads"]]
             + [k for c in BENCHMARK["configs"] for k in c["reduced"]])
    for name in names:
        assert spec.NAME_RE.match(name), name
    for m in METRICS:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (BENCHMARK["configs"], BENCHMARK["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_moves_target_is_reported_by_each_listed_cell():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in target.get("workloads", CELLS), (m["name"], cell)
    for cell in CELLS:
        p = spec.plan(cell)
        names = {m["name"] for m in p.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert p.per_layer


def test_bounds_sources_and_run_length_keep_the_contract():
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCHMARK["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    rs = BENCHMARK["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for w in BENCHMARK["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_and_readers_by_name(cell):
    p = spec.plan(cell)
    assert p.config["name"] == p.workload["config"]
    assert p.traffic["name"] == p.workload["traffic"]
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    assert p.workload["why"] == entry["why"]
    for m in p.end_to_end + p.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    cfg_entry = next(c for c in BENCHMARK["configs"]
                     if c["name"] == p.workload["config"])
    assert (ROOT / cfg_entry["file"]).exists()
    assert set(p.workload["limits"]) == {"loss_gap", "first_gap",
                                         "change_gap"}


def _copy(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    return root


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    new = dict(json.loads(
        (root / "portbench/workloads/qwen3-1.7b.mavg-k4.json").read_text()),
        name="qwen3-1.7b.mavg-k2", traffic="mavg-k2")
    (root / "portbench/workloads/qwen3-1.7b.mavg-k2.json").write_text(
        json.dumps(new))
    traffic = dict(json.loads(
        (root / "portbench/traffic/mavg-k4.json").read_text()),
        name="mavg-k2", k_steps=2)
    (root / "portbench/traffic/mavg-k2.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/step.count.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench["workloads"].append({k: new[k] for k in
                               ("name", "config", "traffic", "chips", "why")})
    bench["per_layer"].append({
        "name": "step.count", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "trainer",
        "moves": "train_tokens_per_s", "workloads": ["qwen3-1.7b.mavg-k2"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("qwen3-1.7b.mavg-k2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = spec.plan("qwen3-1.7b.mavg-k2", bench_dir=root / "portbench")
    assert p.traffic["k_steps"] == 2
    assert "step.count" in [m["name"] for m in p.per_layer]
    read = spec.metric_reader("step.count", root / "portbench")
    assert read(type("Ctx", (), {"steps": 3})) == 3.0
    # a quantity split by cells reads like its base
    split = spec.metric_reader("step.count.k2", root / "portbench")
    assert split(type("Ctx", (), {"steps": 4})) == 4.0
    with pytest.raises(spec.SpecError):
        spec.plan("qwen3-1.7b.mavg-k3", bench_dir=root / "portbench")


def test_configurations_are_the_ports_at_their_published_sizes():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config

    # the port's configurations keep their own norm_eps and aux-loss
    # coefficient; the benchmark runs the published ones
    published = {"norm_eps": "rms_norm_eps", "moe_aux_coef": "aux_loss_alpha"}
    port_name = {"qwen3-1.7b": "qwen3-1.7b",
                 "deepseek-moe-16b-l3": "deepseek-moe-16b"}
    for entry in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["source"].startswith(entry["source"])
        port = get_config(port_name[entry["name"]])
        for key, value in cfg["model"].items():
            if key in ("name",) or key in entry["reduced"]:
                continue
            if key in published:
                assert value == cfg["published"][published[key]]
            else:
                assert value == getattr(port, key), key
        hf = cfg["published"]
        m = cfg["model"]
        for key, hf_key in (("d_model", "hidden_size"),
                            ("num_heads", "num_attention_heads"),
                            ("num_kv_heads", "num_key_value_heads"),
                            ("d_ff", "intermediate_size"),
                            ("vocab_size", "vocab_size"),
                            ("tie_embeddings", "tie_word_embeddings"),
                            ("rope_theta", "rope_theta")):
            assert m[key] == hf[hf_key], key
        assert (m["num_layers"] == hf["num_hidden_layers"]) == (
            "num_layers" not in entry["reduced"])
    moe = json.loads((BENCH / "configs/deepseek-moe-16b-l3.json").read_text())
    hf, m = moe["published"], moe["model"]
    assert (m["num_experts"], m["num_shared_experts"], m["moe_top_k"],
            m["d_expert"], m["first_dense_layers"]) == (
        hf["n_routed_experts"], hf["n_shared_experts"],
        hf["num_experts_per_tok"], hf["moe_intermediate_size"],
        hf["first_k_dense_replace"])


@pytest.mark.parametrize("name", ["qwen3-1.7b", "deepseek-moe-16b-l3"])
def test_stated_parameter_counts_follow_from_the_shapes(name):
    import math

    from benchlib import inputs, yardstick

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    layout = inputs.param_layout(cfg["model"])
    assert cfg["params"]["total"] == sum(math.prod(s)
                                         for s, _ in layout.values())
    key = "matmul" if "matmul" in cfg["params"] else "matmul_active"
    assert cfg["params"][key] == yardstick.active_matmul_params(cfg["model"])


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{BENCH}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_imports_no_jax_and_the_reference_nothing_of_the_port():
    run_mods = _modules_after(
        "import runpy; mod = runpy.run_path('portbench/run.py', "
        "run_name='planned')\n"
        "from benchlib import spec, program, ref_mavg, profile, compare\n"
        "for c in ('qwen3-1.7b.mavg-k4', 'deepseek-moe-16b-l3.mavg-k4'):\n"
        "    p = spec.plan(c)\n"
        "    [spec.metric_reader(m['name']) for m in p.end_to_end "
        "+ p.per_layer]")
    assert "repro_torch" in run_mods
    assert not run_mods & {"jax", "jaxlib", "flax", "repro"}
    ref_mods = _modules_after(
        "from benchlib import ref_mavg, ref_transformer, compare, inputs, "
        "yardstick")
    assert not ref_mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py runs")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         CELLS[0], "--seed", str(2**31 + 11), "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and not out.stdout.strip()


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    root = _copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.argv = ['run.py']; "
         "runpy.run_path('portbench/run.py', run_name='planned'); "
         "from benchlib import program"],
        capture_output=True, text=True, cwd=root, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "repro_torch" in out.stderr

