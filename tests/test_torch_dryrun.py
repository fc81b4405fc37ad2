"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_lib``,
``sharding/placed.py``) and its tables against the JAX package's.

* On a (1, 1) mesh the placed meta step is the unplaced one: its
  ``jit_cost`` equals the unplaced step's exactly (flops, bytes, kernel
  calls; no collective), and on CPU tensors its planes equal the
  unplaced step's bitwise (``chip_smoke.py`` phases 19a and 19b).
* On the (4, 2) mesh of JAX's ``tests/test_dryrun_smoke.py`` (its reduced
  config): the meta average shows as an all-reduce over 'data' of the
  device's plane, and the per-device flops are within 1 % of JAX's row
  under each remat policy, ``full`` (the default of both), ``dots`` and
  ``everything``, and under ``tp_mode="fsdp"`` (the local batch split
  over 'model', the gradient all-reduced over it; JAX in a subprocess
  with 8 host devices, once for the four rows).
* Layer-scaled costing (the default) equals the eager count of every
  layer at 3 layers (1- and 2-layer runs are its anchors; xLSTM's
  recurrences scaled over time too) in flops, bytes, collectives, kernel
  calls and argument and output bytes; the temporaries, a peak, are
  exact for the dense and MoE rows and within 11 % for Hymba's and
  xLSTM's. At full size Qwen3-1.7B's train_4k row is the eager row in
  every field, under ``full`` and ``everything``.
* The collective counts match hand counts on a learner mean and a
  row-parallel linear.
* The CLI writes a full-size row (qwen3-1.7b, train_4k, single mesh) with
  JAX's keys; ``run.py --only roofline`` tabulates it; E3's
  ``H100_COMM_RATIO`` is recomputed from it.
* The tables equal JAX's ``markdown_table`` / ``roofline_table`` /
  ``dryrun_table`` strings on the same rows, and ``build_experiments``
  fails on the missing ``EXPERIMENTS.md`` as JAX's does.

Each file starts the fake process group it needs and destroys it at
teardown (``fake_group``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import base as B  # noqa: E402
from repro_torch.core.meta import init_state, meta_step  # noqa: E402
from repro_torch.launch import dryrun_lib as D  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.roofline.cost import jit_cost  # noqa: E402
from repro_torch.sharding import Spec  # noqa: E402
from repro_torch.sharding.placed import (  # noqa: E402
    GroupMeanReducer,
    Placement,
    placed_meta_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_SHAPE = B.InputShape("train_4k", 64, 8, "train")  # JAX's smoke
SMOKE_K = 2  # local steps of a dry-run row (specs.DRYRUN_K_STEPS)


def _smoke_cfg():
    return dataclasses.replace(
        B.get_config("qwen3-1.7b").reduced(), d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256)


@pytest.fixture
def fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _loss(cfg):
    return lambda p, b: api.loss_fn(p, cfg, b)


def _state_and_batches(cfg, mcfg, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    params = api.init_params(gen, cfg, device)
    state = init_state(params, mcfg)
    batches = {}
    for name, (shp, dtype) in api.batch_shapes(cfg, 2, 16).items():
        shape = (mcfg.num_learners, mcfg.k_steps) + tuple(shp)
        batches[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, dtype=dtype)
    return state, batches


def _placed(state, batches, cfg, mcfg, mesh):
    st = S.place_tree(state, S.state_shardings(cfg, mcfg, mesh), mesh)
    bt = {k: S.place(v, Spec("data"), mesh) for k, v in batches.items()}
    return st, bt


# ---------------------------------------------------------------------------
# the (1, 1) mesh: the unplaced step, op for op
# ---------------------------------------------------------------------------


def test_a_1x1_placed_step_costs_the_unplaced_step_exactly(fake_group):
    cfg = _smoke_cfg()
    mcfg = B.MAvgConfig(num_learners=4, k_steps=2, momentum=0.7)
    state, batches = _state_and_batches(cfg, mcfg, "cpu")
    want = jit_cost(lambda s, b: meta_step(s, b, loss_fn=_loss(cfg),
                                           cfg=mcfg, lr=0.01),
                    state, batches, in_place=(0,))
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    placement = Placement(mesh, ("data",))
    st, bt = _placed(state, batches, cfg, mcfg, mesh)
    got = D.cost_program(
        lambda s, b: placed_meta_step(s, b, loss_fn=_loss(cfg), cfg=mcfg,
                                      placement=placement, lr=0.01),
        (st, bt), dict(in_place=(0,), groups=placement.labels))
    assert got.flops == want.flops > 0
    assert got.hbm_bytes == want.hbm_bytes
    assert got.kernel_calls == want.kernel_calls == {
        "sgd_apply": 8, "fused_momentum_broadcast": 1}
    assert got.arg_bytes == want.arg_bytes
    assert got.collective_bytes == 0 and got.collective_calls == 0


def test_a_1x1_placed_step_equals_the_unplaced_step_bitwise(fake_group):
    cfg = _smoke_cfg()
    mcfg = B.MAvgConfig(num_learners=4, k_steps=2, momentum=0.7)
    ref, batches = _state_and_batches(cfg, mcfg, "cpu")
    mine, _ = _state_and_batches(cfg, mcfg, "cpu")
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    placement = Placement(mesh, ("data",))
    st, bt = _placed(mine, batches, cfg, mcfg, mesh)
    for _ in range(2):
        ref, mr = meta_step(ref, batches, loss_fn=_loss(cfg), cfg=mcfg,
                            lr=0.01)
        st, mp = placed_meta_step(st, bt, loss_fn=_loss(cfg), cfg=mcfg,
                                  placement=placement, lr=0.01)
    assert st.step == ref.step == 2
    for f in ("global_params", "momentum", "learners"):
        assert torch.equal(getattr(st, f).to_local(), getattr(ref, f)), f
    assert float(mp["loss"]) == float(mr["loss"])


# ---------------------------------------------------------------------------
# collectives against hand counts
# ---------------------------------------------------------------------------


def test_learner_mean_is_one_all_reduce_of_the_local_plane(fake_group):
    mesh = D.fake_mesh((2, 4, 2), ("pod", "data", "model"))
    rows = 64
    learners = S.place(torch.empty((16, rows, 128), device="meta"),
                       Spec(("pod", "data"), "model", None), mesh)
    gp = S.place(torch.empty((rows, 128), device="meta"),
                 Spec("model", None), mesh)
    placement = Placement(mesh, ("pod", "data"))
    red = GroupMeanReducer("float32", placement)
    c = jit_cost(lambda l, g: red.reduce(l.to_local(), g.to_local(), None,
                                         step=0)[0],
                 learners, gp, groups=placement.labels)
    local_plane = rows // 2 * 128 * 4
    assert c.collectives_by_type == {"all-reduce": local_plane}
    assert c.collectives_by_axes == {"pod,data": local_plane}
    assert c.collective_calls == 1


def test_row_parallel_linear_is_one_all_reduce_over_model(fake_group):
    from torch.distributed.tensor import Replicate

    mesh = D.fake_mesh((4, 2), ("data", "model"))
    Bt, d, f = 16, 64, 32
    x = S.place(torch.empty(Bt, d, device="meta"), Spec(None, "model"), mesh)
    w = S.place(torch.empty(d, f, device="meta"), Spec("model", None), mesh)

    def linear(x, w):
        return (x @ w).redistribute(mesh, [Replicate(), Replicate()])

    c = jit_cost(linear, x, w, groups=Placement(mesh, ("data",)).labels)
    assert c.flops == 2 * Bt * (d // 2) * f  # this rank's half of d
    assert c.collectives_by_type == {"all-reduce": Bt * f * 4}
    assert c.collectives_by_axes == {"model": Bt * f * 4}
    assert c.arg_bytes == (Bt * d + d * f) * 4 // 2


def test_a_row_split_plane_is_gathered_once_and_averaged_once(fake_group):
    """Rows split over 'model': the local phase all-gathers this rank's
    learner plane once, the mix all-reduces the local rows once."""
    from repro_torch.pack import make_pack_spec

    base = _smoke_cfg()
    cfg = next(c for c in (dataclasses.replace(base, vocab_size=v)
                           for v in range(256, 1024, 8))
               if make_pack_spec(S.abstract_params(c)).rows % 16 == 0)
    rows = make_pack_spec(S.abstract_params(cfg)).rows
    mesh = D.fake_mesh((4, 2), ("data", "model"))
    mcfg = B.MAvgConfig(num_learners=4, k_steps=2, momentum=0.7)
    st, bt = _placed(S.abstract_state(cfg, mcfg),
                     S.train_input_specs(cfg, SMOKE_SHAPE, 4, 2), cfg, mcfg,
                     mesh)
    assert tuple(st.learners.to_local().shape) == (1, rows // 2, 128)
    placement = Placement(mesh, ("data",))
    c = D.cost_program(
        lambda s, b: placed_meta_step(s, b, loss_fn=_loss(cfg), cfg=mcfg,
                                      placement=placement),
        (st, bt), dict(in_place=(0,), groups=placement.labels))
    plane = rows * 128 * 4
    assert c.collectives_by_type["all-gather"] == plane
    # the rows gathered, then the sums of squares of the two plane norms
    # (displacement_norm, v_norm)
    assert c.collectives_by_axes["model"] == plane + 2 * 4
    # the local rows' mean, then the loss, grad-norm and step-count sums
    # and the loss spread's two extremes
    assert c.collectives_by_axes["data"] == plane // 2 + 3 * 4 + 2 * 4
    # consensus_dist's sum of squares over every rank's pieces
    assert c.collectives_by_axes["data,model"] == 4


PLACED_MIXES = {
    "int8_ef": dict(comm=B.CommConfig(scheme="int8")),
    "hier_dense": dict(topology=B.TopologyConfig(
        kind="hierarchical", groups=2, outer_every=2)),
    "hier_elastic_dense": dict(topology=B.TopologyConfig(
        kind="hierarchical", groups=2, outer_every=2,
        elastic=B.ElasticConfig(period=4, drop_frac=0.25, seed=1))),
    "hier_int8_ef_inner": dict(topology=B.TopologyConfig(
        kind="hierarchical", groups=2, outer_every=2,
        inner_comm=B.CommConfig(scheme="int8"))),
    "gossip_dense": dict(topology=B.TopologyConfig(kind="gossip")),
    "gossip_int8_ef": dict(topology=B.TopologyConfig(
        kind="gossip", momentum_tracking=True,
        inner_comm=B.CommConfig(scheme="int8"))),
}


@pytest.mark.parametrize("name", list(PLACED_MIXES))
def test_the_placed_mixes_move_and_hold_less_than_the_gathered_ones(
        fake_group, name):
    """Why a placed mix runs on the rank's pieces and not on the gathered
    stack (``GatheredMix``, which runs the one-process mix on every rank):
    the mix of one rank costed at Qwen3-1.7B's full width on a fake (4, 2)
    mesh, L = 8 (2 learners a rank; the plane's 13,441,992 rows do not
    split over 'model' in 8-row multiples), at a step where the outer
    level fires. The flat int8 + EF mix and the dense-inner hierarchical
    ones move a third or less of the gathered mix's collective bytes and
    hold half or less of its peak; with an int8 + EF inner level the
    gathered mix is the one taken, and moves no more than JAX's
    replicated (G, S, rows, 128) inner residual, which a rank-pieces mix
    would have to gather besides its partial sums. Gossip on the pieces
    gathers each mixed stack over the learner axes (the rows stay split):
    dense, half the gathered mix's bytes and peak or less; with int8 + EF
    and momentum tracking it holds less, but moves up to the replicated
    (L, rows, 128) residual more than the gathered mix, whose ranks each
    update the whole residual themselves (a halo exchange of the
    neighbours' planes alone is ROADMAP's)."""
    from repro_torch.sharding.placed import (
        GatheredMix,
        RankView,
        local_state,
        placed_topology,
    )
    from repro_torch.topology import make_topology

    cfg = B.get_config("qwen3-1.7b")
    mcfg = B.MAvgConfig(num_learners=8, k_steps=2, **PLACED_MIXES[name])
    mesh = D.fake_mesh((4, 2), ("data", "model"))
    state = S.place_tree(S.abstract_state(cfg, mcfg),
                         S.state_shardings(cfg, mcfg, mesh), mesh)
    placement = Placement(mesh, ("data",))
    view = RankView(state, placement)
    loc = local_state(state)
    host = tuple(v for k, v in (loc.topo or {}).items() if k == "membership")

    def cost(topology):
        def mix(learners, gp, v, res, topo):
            return topology.mix(learners, gp, v, res, topo, step=1)

        return D.cost_program(mix, (loc.learners, loc.global_params,
                                    loc.momentum, loc.comm_residual,
                                    loc.topo),
                              dict(in_place=(0, 1, 2, 3, 4), host=host,
                                   groups=placement.labels))

    chosen = placed_topology(mcfg, view)
    gathered = cost(GatheredMix(make_topology(mcfg), view))
    print(f"{name}: gathered {gathered.collective_bytes:.0f} collective "
          f"bytes, peak {gathered.temp_bytes}")
    if name == "hier_int8_ef_inner":
        assert isinstance(chosen, GatheredMix)
        res = loc.topo["inner_residual"]
        assert gathered.collective_bytes <= res.numel() * res.element_size()
        return
    assert not isinstance(chosen, GatheredMix)
    placed = cost(chosen)
    print(f"{name}: placed {placed.collective_bytes:.0f} collective bytes, "
          f"peak {placed.temp_bytes}")
    assert placed.kernel_calls.keys() == gathered.kernel_calls.keys()
    if name == "gossip_int8_ef":
        res = loc.topo["residual"]
        assert placed.temp_bytes < gathered.temp_bytes
        assert placed.collective_bytes <= (gathered.collective_bytes
                                           + res.numel() * res.element_size())
        return
    ratio = 2 if name.startswith("gossip") else 3
    assert ratio * placed.collective_bytes <= gathered.collective_bytes
    assert 2 * placed.temp_bytes <= gathered.temp_bytes


# ---------------------------------------------------------------------------
# the (4, 2) mesh against JAX's dry run
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
from repro.configs import get_config
from repro.configs.base import INPUT_SHAPES, InputShape
from repro.launch import mesh as meshlib
from repro.models import transformer
import repro.launch.dryrun_lib as DL
meshlib.SINGLE_POD_SHAPE = (4, 2)
INPUT_SHAPES["train_4k"] = InputShape("train_4k", 64, 8, "train")
cfg = dataclasses.replace(
    get_config("qwen3-1.7b").reduced(), d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256)
DL.get_config = lambda a: cfg
out = {}
for case in ("full", "dots", "everything", "fsdp"):
    transformer.set_remat_policy("full" if case == "fsdp" else case)
    r = DL.run_one("qwen3-1.7b", "train_4k", "single",
                   tp_mode="fsdp" if case == "fsdp" else "megatron")
    out[case] = {"flops": r["hlo_cost"]["flops"],
                 "coll": r["collectives"]["total"],
                 "args": r["memory"]["argument_size_in_bytes"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_small_rows(tmp_path_factory):
    """JAX's (4, 2) train rows under each case, from one subprocess."""
    script = tmp_path_factory.mktemp("jdr") / "jdr.py"
    script.write_text(JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["full", "dots", "everything", "fsdp"])
def test_small_mesh_dry_run_against_jax(fake_group, monkeypatch,
                                        jax_small_rows, case):
    """The (4, 2) train row against JAX's under the same remat policy
    (``fsdp``: JAX's default policy, tp_mode 'fsdp'). The test keeps its
    name: it held the rows of JAX's two policies against the port's one,
    before the port had remat."""
    from repro_torch.models import transformer

    cfg = _smoke_cfg()
    monkeypatch.setitem(B.INPUT_SHAPES, "train_4k", SMOKE_SHAPE)
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(meshlib, "SINGLE_POD_SHAPE", (4, 2))
    monkeypatch.setattr(transformer, "REMAT_POLICY",
                        "full" if case == "fsdp" else case)
    tp_mode = "fsdp" if case == "fsdp" else "megatron"
    row = D.run_one("qwen3-1.7b", "train_4k", "single", tp_mode=tp_mode)
    assert not row["skipped"] and row["collectives"]["total"] > 0
    from repro_torch.pack import make_pack_spec

    plane = make_pack_spec(S.abstract_params(cfg)).rows * 128 * 4
    coll = row["collectives"]
    assert coll["by_type"] == {"all-reduce": coll["total"]}
    assert coll["by_axes"]["data"] >= plane
    if tp_mode == "fsdp":
        # each local step's gradient plane and loss, averaged over 'model'
        assert coll["by_axes"]["model"] == SMOKE_K * (plane + 4)
    else:
        assert "model" not in coll["by_axes"]
    assert row["kernel_calls"] == {"sgd_apply": 2,
                                   "fused_momentum_broadcast": 1}
    want = jax_small_rows[case]
    flops = row["hlo_cost"]["flops"]
    print(f"{case}: port {flops:.6e} flops, JAX {want['flops']:.6e} "
          f"({flops / want['flops'] - 1:+.4%})")
    assert abs(flops - want["flops"]) / want["flops"] < 0.01
    # the state and batches a device holds: JAX's bytes, less its 4-byte
    # int32 step (the port's step is a host int)
    assert row["memory"]["argument_size_in_bytes"] == want["args"] - 4


@pytest.mark.parametrize("policy", ["full", "everything"])
def test_full_size_train_row_is_layer_scaled_exactly(fake_group, monkeypatch,
                                                      policy):
    """Qwen3-1.7B train_4k on the (32, 8) mesh: 28 layers counted eagerly
    and scaled from 1 and 2, every field equal; the temporaries fall from
    552 GB a device (``everything``) to 72 GB under ``full``."""
    from repro_torch.models import transformer

    monkeypatch.setattr(transformer, "REMAT_POLICY", policy)
    scaled = D.run_one("qwen3-1.7b", "train_4k", "single")
    eager = D.run_one("qwen3-1.7b", "train_4k", "single",
                      layer_scaled=False)
    for key in ("memory", "cost", "collectives", "kernel_calls",
                "n_collective_sites"):
        assert scaled[key] == eager[key], key
    temp = scaled["memory"]["temp_size_in_bytes"] / 1e9
    print(f"{policy}: temporaries {temp:.3f} GB a device")
    assert (temp < 80) if policy == "full" else (temp > 500)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "hymba-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_layer_scaled_row_equals_the_eager_count(fake_group, monkeypatch,
                                                 arch, kind):
    base = B.get_config(arch).reduced()
    extra = base.first_dense_layers if base.num_experts else 0
    per = base.slstm_every if base.family == "ssm" else 1
    cfg = dataclasses.replace(base, num_layers=3 * per + extra)
    name = f"{kind}_small"
    monkeypatch.setitem(B.INPUT_SHAPES, name,
                        B.InputShape(name, 16 if kind == "train" else 32, 8,
                                     kind))
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(meshlib, "SINGLE_POD_SHAPE", (4, 2))
    scaled = D.run_one(arch, name, "single")
    eager = D.run_one(arch, name, "single", layer_scaled=False)
    assert scaled["layer_scaled"] and not eager["layer_scaled"]
    for key in ("cost", "collectives", "kernel_calls",
                "n_collective_sites"):
        assert scaled[key] == eager[key], key
    mem, want = scaled["memory"], eager["memory"]
    temp = "temp_size_in_bytes"
    for key in mem:
        if key != temp:
            assert mem[key] == want[key], key
    # the temporaries are a peak, not a sum: scaled from the anchors
    # (linearly with autograd, the anchors' largest without), exact where
    # the peak grows layer by layer or sits in one layer; Hymba's train
    # row reads 2.6 % low and xLSTM's rows up to 10.7 % low (their peaks
    # move between the anchors and the 3-layer program)
    err = mem[temp] / want[temp] - 1
    print(f"{arch} {kind}: temporaries {mem[temp]:.0f} scaled, "
          f"{want[temp]:.0f} eager ({err:+.3%})")
    if base.family in ("dense", "moe") or (arch, kind) == ("hymba-1.5b",
                                                           "prefill"):
        assert mem[temp] == want[temp]
    else:
        assert abs(err) < 0.11, err


# ---------------------------------------------------------------------------
# serving rows on the small mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_rows_on_a_small_mesh(fake_group, monkeypatch, arch, kind):
    cfg = B.get_config(arch).reduced()
    name = f"{kind}_small"
    monkeypatch.setitem(B.INPUT_SHAPES, name,
                        B.InputShape(name, 64, 8, kind))
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(meshlib, "SINGLE_POD_SHAPE", (4, 2))
    row = D.run_one(arch, name, "single")
    assert row["cost"]["flops"] > 0 and row["collectives"]["total"] > 0
    assert set(row["collectives"]["by_axes"]) <= {"data", "model",
                                                  "data,model"}
    assert row["memory"]["argument_size_in_bytes"] > 0
    assert row["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


# ---------------------------------------------------------------------------
# the CLI at full size, the roofline suite and E3's ratio
# ---------------------------------------------------------------------------


def test_cli_writes_a_full_size_row(fake_group, monkeypatch, tmp_path,
                                    capsys):
    from repro_torch.benchmarks import k_sweep, roofline_table, run
    from repro_torch.launch import dryrun
    from repro_torch.pack import make_pack_spec

    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                        "--mesh", "single"]) == 0
    path = tmp_path / "qwen3-1.7b__train_4k__single__faithful.json"
    row = json.loads(path.read_text())
    assert set(row["memory"]) >= {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert row["cost"]["flops"] > 0 and row["roofline"]["chips"] == 256
    assert "modeled" in row and "not a measurement" in row["modeled"]
    cfg = B.get_config("qwen3-1.7b")
    rows = make_pack_spec(S.abstract_params(cfg)).rows
    split = 8 if rows % 64 == 0 else 1
    plane = rows * 128 * 4 // split
    assert row["collectives"]["by_type"]["all-reduce"] >= plane
    assert row["collectives"]["by_axes"]["data"] >= plane
    assert row["n_collective_sites"] >= 1
    for key in ("generated_code_size_in_bytes", "hlo_lines", "compile_s"):
        assert key not in row and key not in row["memory"]
    rf = row["roofline"]
    assert k_sweep.H100_COMM_RATIO == rf["collective_s"] / rf["compute_s"]
    # the roofline suite tabulates it
    monkeypatch.setattr(roofline_table, "RESULTS", str(tmp_path))
    capsys.readouterr()
    run.main(["--only", "roofline", "--bench-dir", ""])
    out = capsys.readouterr().out
    assert "| qwen3-1.7b | train_4k | single |" in out
    assert "bench,roofline," in out and ",ok" in out
    with pytest.raises(SystemExit, match="no counterpart"):
        dryrun.main(["--save-hlo"])


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------




def test_tables_equal_jax(fake_group, monkeypatch, tmp_path):
    from benchmarks import build_experiments as jbe
    from benchmarks import roofline_table as jrt
    from repro_torch.benchmarks import build_experiments as tbe
    from repro_torch.benchmarks import roofline_table as trt

    skipped = D.run_one("hubert-xlarge", "decode_32k", "single")
    assert skipped["skipped"]
    cfg = _smoke_cfg()
    monkeypatch.setitem(B.INPUT_SHAPES, "train_4k", SMOKE_SHAPE)
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(meshlib, "SINGLE_POD_SHAPE", (4, 2))
    rows = [D.run_one("qwen3-1.7b", "train_4k", "single"),
            skipped]
    multi = dict(rows[0], mesh="multi", arch="deepseek-moe-16b")
    rows.append(multi)
    for i, r in enumerate(rows):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    assert trt.markdown_table(rows) == jrt.markdown_table(rows)
    monkeypatch.setattr(jrt, "RESULTS", str(tmp_path))
    assert trt.load_results(mesh="single", results=str(tmp_path)) == \
        jrt.load_results(mesh="single")
    assert tbe.roofline_table(str(tmp_path)) == jbe.roofline_table()
    assert tbe.dryrun_table(str(tmp_path)) == jbe.dryrun_table()
    assert trt.summarize(rows) == jrt.summarize(rows)


def test_build_experiments_fails_without_its_target_as_jax(tmp_path):
    from benchmarks import build_experiments as jbe
    from repro_torch.benchmarks import build_experiments as tbe

    assert not os.path.exists(os.path.join(REPO, "EXPERIMENTS.md"))
    with pytest.raises(FileNotFoundError):
        jbe.main()
    with pytest.raises(FileNotFoundError):
        tbe.main()
    target = tmp_path / "EXP.md"
    target.write_text("a\n<!-- AUTOGEN:roofline -->\nold\n"
                      "<!-- /AUTOGEN:roofline -->\nb\n")
    tbe.main(str(target), results=str(tmp_path))
    text = target.read_text()
    assert "old" not in text and "| arch | shape | mesh | HLO FLOPs/dev" in text


def test_a_dtensor_reaches_the_kernels_through_its_local_pieces(fake_group):
    """``kernels/ops.py``: the elementwise kernels take DTensors of one
    layout through this rank's pieces (and charge the pieces' cost);
    anything else raises, and ``_route`` refuses a DTensor outright."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.local_sgd import cost as sgd_cost

    mesh = D.fake_mesh((4, 2), ("data", "model"))
    w, g, whole = (S.place(torch.empty((64, 128), device="meta"), spec, mesh)
                   for spec in (Spec("model", None), Spec("model", None),
                                Spec(None, None)))
    c = jit_cost(lambda w, g: kops.sgd_apply(w, g, 0.1, out=w), w, g,
                 in_place=(0,))
    assert c.kernel_calls == {"sgd_apply": 1}
    piece = torch.empty((32, 128), device="meta")
    assert c.hbm_bytes == sgd_cost(piece, piece, 0.1).nbytes
    with pytest.raises(TypeError, match="DTensor reached a kernel"):
        kops._route(w, None, None, None)
    with pytest.raises(ValueError, match="do not line up"):
        jit_cost(lambda w, g: kops.sgd_apply(w, g, 0.1, out=w), w, whole)
    dist.destroy_process_group()
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    gp, v, a = (torch.randn((16, 128), generator=gen) for _ in range(3))
    lrn = torch.randn((3, 16, 128), generator=gen)
    plain = [t.clone() for t in (gp, v, a, lrn)]
    kops.fused_momentum_broadcast(*plain[:3], mu=0.7, num_learners=3,
                                  w_out=plain[0], v_out=plain[1],
                                  learners_out=plain[3])
    placed = [S.place(t, Spec("model", None), mesh) for t in (gp, v, a)]
    placed.append(S.place(lrn, Spec("data", "model", None), mesh))
    kops.fused_momentum_broadcast(*placed[:3], mu=0.7, num_learners=3,
                                  w_out=placed[0], v_out=placed[1],
                                  learners_out=placed[3])
    for p, q in zip(placed, plain):
        assert torch.equal(p.to_local(), q)


# ---------------------------------------------------------------------------
# every configuration the placed step and the Trainer on a mesh take
# ---------------------------------------------------------------------------


def _runs_placed_on_1x1(mcfg, chaos=None):
    """Two meta steps placed on a (1, 1) mesh equal the unplaced steps
    bitwise (planes, residual, topology buffers, every metric), and then
    the placed step's ``jit_cost`` is the unplaced step's in flops, bytes
    and kernel calls, with no collective (costed after the two steps: the
    async server's de-phased clocks may fire no learner on the first)."""
    from repro_torch.topology import host_buffers, make_topology
    from repro_torch.utils.tree import tree_leaves

    cfg = _smoke_cfg()
    ref, batches = _state_and_batches(cfg, mcfg, "cpu")
    mine, _ = _state_and_batches(cfg, mcfg, "cpu")
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    placement = Placement(mesh, ("data",))
    st, bt = _placed(mine, batches, cfg, mcfg, mesh)
    topology = make_topology(mcfg)
    unplaced = lambda s, b: meta_step(s, b, loss_fn=_loss(cfg), cfg=mcfg,
                                      lr=0.01, topology=topology, chaos=chaos)
    placed = lambda s, b: placed_meta_step(s, b, loss_fn=_loss(cfg),
                                           cfg=mcfg, placement=placement,
                                           lr=0.01, chaos=chaos)
    for _ in range(2):
        ref, mr = unplaced(ref, batches)
        st, mp = placed(st, bt)
        assert set(mp) == set(mr)
        for k in mr:
            assert float(mp[k]) == float(mr[k]), k

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(
            torch.equal(local(x), y) for x, y in zip(la, lb))

    for f in ("global_params", "momentum", "learners", "comm_residual"):
        if getattr(ref, f) is not None:
            assert same(getattr(st, f), getattr(ref, f)), f
    for k, v in (ref.topo or {}).items():
        if v is not None:
            assert same(st.topo[k], v), k
    want = jit_cost(unplaced, ref, batches, in_place=(0,),
                    host=host_buffers(ref.topo))
    got = D.cost_program(placed, (st, bt), dict(
        in_place=(0,), groups=placement.labels,
        host=host_buffers(st.topo)))
    assert got.flops == want.flops > 0
    assert got.hbm_bytes == want.hbm_bytes
    assert got.kernel_calls == want.kernel_calls
    assert got.collective_bytes == 0 and got.collective_calls == 0


@pytest.mark.parametrize("change", [
    pytest.param(dict(packed=False), id="per_leaf"),
    pytest.param(dict(comm=B.CommConfig(scheme="int8")), id="int8_ef"),
    pytest.param(dict(topology=B.TopologyConfig(
        kind="hierarchical", groups=2, outer_every=1,
        inner_comm=B.CommConfig(scheme="int8"),
        elastic=B.ElasticConfig(drop_frac=0.25, period=2))),
        id="hierarchical"),
    pytest.param(dict(topology=B.TopologyConfig(
        kind="gossip", momentum_tracking=True, inner_comm=B.CommConfig(
            scheme="int8", chunk_rows=8))), id="gossip"),
    pytest.param(dict(topology=B.TopologyConfig(
        kind="async", server=B.AsyncConfig(staleness=3,
                                           step_time=(1, 1, 2, 4)))),
        id="async"),
    pytest.param(dict(robust=B.RobustConfig(estimator="trimmed", trim=1,
                                            clip_mult=3.0, clip_window=1)),
                 id="robust"),
    pytest.param(dict(finite_guard=True), id="finite_guard"),
    pytest.param(dict(algorithm="eamsgd"), id="eamsgd"),
    pytest.param(dict(algorithm="downpour"), id="downpour"),
])
def test_placed_step_on_a_1x1_mesh_is_the_unplaced_step(fake_group, change):
    """Every configuration runs placed: per-leaf planes, int8 + EF, the
    hierarchical and gossip topologies (ring, momentum tracking, int8 + EF
    exchange), the async server (profile (1, 1, 2, 4)), robust
    aggregation, the finite guard, eamsgd and downpour, each on a (1, 1)
    mesh the unplaced step bitwise and costed alike
    (``_runs_placed_on_1x1``)."""
    mcfg = B.MAvgConfig(num_learners=4, k_steps=2, momentum=0.7, **change)
    nan = None
    if mcfg.finite_guard:
        def nan(learners, step, offset=0):  # learner 1 NaN at step 1
            if int(step) == 1:
                learners[1 - offset].fill_(float("nan"))
            return learners
    _runs_placed_on_1x1(mcfg, chaos=nan)


@pytest.mark.parametrize("algorithm", ["mavg", "kavg", "sync",
                                       "mavg_mlocal"])
def test_placed_step_takes_the_averaging_algorithms(fake_group, algorithm):
    """The averaging algorithms take the flat mix on the rank's pieces
    (``PlacedFlat``), not the gathered one."""
    from repro_torch.sharding.placed import (
        PlacedFlat,
        RankView,
        placed_topology,
    )

    cfg = _smoke_cfg()
    mcfg = B.MAvgConfig(algorithm=algorithm, num_learners=4, k_steps=2)
    state, batches = _state_and_batches(cfg, mcfg, "cpu")
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    st, _ = _placed(state, batches, cfg, mcfg, mesh)
    view = RankView(st, Placement(mesh, ("data",)))
    assert isinstance(placed_topology(mcfg, view), PlacedFlat)


@pytest.mark.parametrize("what", ["chaos", "cost_analysis", "attribution",
                                  "robust", "gossip", "per_leaf", "async",
                                  "eamsgd", "downpour"])
def test_trainer_on_a_1x1_mesh_runs_every_configuration(fake_group, what):
    """On a (1, 1) mesh a Trainer with chaos (a payload fault), the cost
    analysis, the attribution rows, robust aggregation, gossip, per-leaf
    planes, the async server, eamsgd or downpour runs its steps (the cost
    and the rows present) and logs the records of the Trainer without a
    mesh."""
    from repro_torch.chaos import ChaosConfig, FaultSpec
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import lm_batch_fn

    cfg = B.get_config("qwen3-1.7b").reduced()
    mcfg = B.MAvgConfig(
        num_learners=4, k_steps=1,
        robust=B.RobustConfig() if what == "robust" else None,
        packed=what != "per_leaf",
        algorithm=what if what in ("eamsgd", "downpour") else "mavg",
        topology=B.TopologyConfig(kind=what if what in ("gossip", "async")
                                  else "flat"))
    obs = B.ObsConfig(cost_analysis=what == "cost_analysis",
                      attribution=what == "attribution")
    chaos = (ChaosConfig(faults=(FaultSpec(kind="payload_scale", step=1,
                                           learner=2),))
             if what == "chaos" else None)
    tcfg = B.TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=2,
                         seq_len=8, meta_steps=2, obs=obs, chaos=chaos)
    mesh = D.fake_mesh((1, 1), ("data", "model"))

    def trainer(mesh):
        return Trainer(
            tcfg, _loss(cfg),
            init_params_fn=lambda g: api.init_params(g, cfg, "cpu"),
            batch_fn=lm_batch_fn(cfg, 4, 1, 2, 8, device="cpu"),
            device="cpu", mesh=mesh)

    tr = trainer(mesh)
    hist = tr.run(log=None)
    assert len(hist) == 2 and all(h["loss"] == h["loss"] for h in hist)
    if what in ("gossip", "per_leaf", "async", "eamsgd", "downpour"):
        skip = ("meta_steps_per_sec", "samples_per_sec", "elapsed_s")
        one = trainer(None).run(log=None)
        assert [{k: v for k, v in h.items() if k not in skip} for h in hist] \
            == [{k: v for k, v in h.items() if k not in skip} for h in one]
    if what == "cost_analysis":
        assert tr.jit_cost is not None and tr.jit_cost.flops > 0
        assert tr.manifest["jit_cost"] is not None
    if what == "attribution":
        assert [r["op"] for r in tr.attribution] == [
            "phase:step", "phase:local", "phase:meta_mix"]
    if what == "robust":
        assert tr.robust_records


# ---------------------------------------------------------------------------
# DeepSeekMoE's prefill at one sequence a 'data' rank (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


def test_moe_prefill_at_one_sequence_a_data_rank(fake_group, monkeypatch):
    """The reduced DeepSeekMoE's prefill row on a (32, 8) mesh at B=32:
    one sequence a 'data' rank, the MoE combine's (T, d) output split along
    T over ('data', 'model'). It is gathered over 'model' before the view
    to (B, S, d) (without it DTensor raised there); the row is
    costed."""
    cfg = B.get_config("deepseek-moe-16b").reduced()
    name = "prefill_one_a_rank"
    monkeypatch.setitem(B.INPUT_SHAPES, name,
                        B.InputShape(name, 64, 32, "prefill"))
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(meshlib, "SINGLE_POD_SHAPE", (32, 8))
    row = D.run_one("deepseek-moe-16b", name, "single")
    assert row["cost"]["flops"] > 0
    assert row["collectives"]["by_axes"].get("model", 0) > 0
