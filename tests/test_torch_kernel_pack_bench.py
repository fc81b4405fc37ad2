"""The port's kernel and pack benches (``repro_torch.benchmarks.
kernel_bench``, ``pack_bench``) against the JAX package's, through
``run.py --only kernel pack`` on the CPU.

* ``meta_plane_rows`` gives JAX's integers (leaves, launches, padding,
  parameters, rows) for llama3-405b, qwen1.5-110b, xlstm-350m and
  hymba-1.5b, from meta-device params.
* ``run.py --only kernel pack --device cpu`` runs both suites, stores
  their rows, and every row is ok: the attribution rows time the plain
  versions (labelled so) against one declared kernel call each; the pack
  parity cells hold JAX's limits (dense within ``DENSE_RTOL``, see
  ``pack_bench``); the in-place meta mix at llama3-405b peaks at 3 + L
  planes against 5 + 2L out of place (ratio 11/21 at L=8, JAX's bar
  0.6), the compress-only kernel saves one plane read, and every
  in-place route is bitwise its out-of-place one.
* A row that is not ok fails the suite.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import kernel_bench as jkernel_bench  # noqa: E402
from repro_torch.benchmarks import kernel_bench, pack_bench, run  # noqa: E402


def test_meta_plane_rows_equal_jax(capsys):
    want = jkernel_bench.meta_plane_rows()
    got = kernel_bench.meta_plane_rows()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.pop("ok") is True
        assert g == w
    out = capsys.readouterr().out
    assert out.count("kernel,meta_launches_per_op,") == 8


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    bench_dir = tmp_path_factory.mktemp("bench")
    run.main(["--only", "kernel", "pack", "--device", "cpu", "--bench-dir",
              str(bench_dir)])
    out = {}
    for suite in ("kernel", "pack"):
        points = [json.loads(line) for line in
                  open(bench_dir / f"BENCH_{suite}.json")]
        assert len(points) == 1 and points[0]["suite"] == suite
        out[suite] = points[0]["rows"]
    return out


def _rows(rows, kind):
    return [r for r in rows if r["row_kind"] == kind]


def test_run_only_kernel_pack_every_row_ok(stored):
    for suite, rows in stored.items():
        assert rows and all(r.get("ok", True) for r in rows), suite
    assert _rows(stored["kernel"], "meta_plane")
    assert len(_rows(stored["pack"], "meta_plane")) == 4


def test_kernel_attribution_rows_time_one_declared_call(stored):
    rows = [r for r in _rows(stored["kernel"], "attribution")
            if "route" in r]
    assert [r["op"] for r in rows] == ["pack_update", "fused_meta",
                                       "neighbor_mix", "quantize"]
    kernels = ["pack_update", "fused_momentum_broadcast", "neighbor_mix",
               "quantize"]
    for r, kernel in zip(rows, kernels):
        assert r["route"] == "plain version (cpu)"
        assert r["kernel_calls"] == {kernel: 1}
        assert r["modeled_hbm_bytes"] > 0 and r["pct_of_bound"] > 0
        assert r["backend"] == "cpu"
    fused = rows[1]
    # the declared cost alone: 3 planes read, 2 + L written
    assert fused["modeled_hbm_bytes"] == (5 + 4) * 1024 * 128 * 4
    parity = _rows(stored["kernel"], "kernel_parity")
    assert {r["op"] for r in parity} == {"fused_momentum_broadcast",
                                         "flash_attention"}
    assert all(r["max_abs_err"] == 0.0 for r in parity)


def test_pack_parity_and_hbm_rows(stored):
    rows = stored["pack"]
    parity = _rows(rows, "pack_parity")
    assert [r["cell"] for r in parity] == [c[0] for c in pack_bench.CELLS]
    for r in parity:
        assert abs(r["loss_ratio"] - 1) < 0.02
        if "int8" not in r["cell"] and "topk" not in r["cell"]:
            assert r["rel_diff"] <= pack_bench.DENSE_RTOL
    peak = _rows(rows, "hbm_peak_state")[0]
    L = pack_bench.HBM_L
    assert peak["peak_out_of_place_planes"] == pytest.approx(5 + 2 * L)
    assert peak["peak_in_place_planes"] == pytest.approx(3 + L)
    assert peak["alias_planes"] == pytest.approx(2 + L)
    assert peak["ratio"] == pytest.approx((3 + L) / (5 + 2 * L))
    compress = _rows(rows, "hbm_compress_only")[0]
    assert compress["plane_reads_removed_measured"] == pytest.approx(1.0)
    assert compress["err_planes_removed_no_ef"] == pytest.approx(L)
    pins = _rows(rows, "hbm_parity")
    assert len(pins) == 8 and all(r["bitwise"] for r in pins)
    attr = _rows(rows, "attribution")
    assert [r["op"] for r in attr] == ["phase:step", "phase:local",
                                       "phase:meta_mix"]
    assert all("pct_of_bound" in r for r in attr)
    assert _rows(rows, "pack_timing")[0]["device"] == "cpu"


def test_a_row_that_is_not_ok_fails_the_suite(monkeypatch):
    for name in ("launches", "hbm_table", "timing", "phase_attribution"):
        monkeypatch.setattr(pack_bench, name, lambda *a, **k: [])
    monkeypatch.setattr(pack_bench, "parity", lambda q, d: [
        {"kind": "pack_parity", "cell": "flat_dense", "ok": False}])
    with pytest.raises(SystemExit, match="flat_dense"):
        pack_bench.main(quick=True, device="cpu")
    # the dry run's suite, refused before the port had a dry run, runs
    # beside these (tests/test_torch_dryrun.py drives it)
    assert {"kernel", "pack", "roofline"} <= set(run.suites(True, "cpu"))
