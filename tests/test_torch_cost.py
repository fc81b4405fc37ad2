"""The port's cost model (``repro_torch.roofline.cost.jit_cost``) against
the JAX package's ``roofline.hlo_cost.jit_cost``, and the kernels' meta
route.

* Forward FLOPs equal JAX's exactly for every family at reduced size,
  B=2, S=16, but xLSTM's: JAX writes the mLSTM normaliser q . n as a dot
  (``einsum("bhk,bhk->bh")``), the port as a multiply and a sum
  (``(n * q).sum(-1)``), so the port counts 2 B S d_inner fewer flops an
  mLSTM block (pinned).
* Gradient FLOPs under each of JAX's remat policies (``full``, ``dots``,
  ``everything``), the port's ``set_remat_policy`` set to the same one
  (both restored after): dense and MoE exactly, the recomputed forward
  included; Hymba's and xLSTM's blocks keep their own remat in both
  packages, whatever the policy. Hymba's gap is pinned: the backward of
  the SSM readout y = h C (``einsum("bsfn,bsn->bsf")``) forms dL/dh as
  an outer product, which XLA rewrites into a multiply and the port runs
  as a ``bmm`` with a contraction of 1, 2 B (S + meta) d_inner N flops a
  layer. xLSTM's gap is pinned as the sum of three terms, each found op
  by op against JAX's HLO dots: the same outer product in the backward
  of the mLSTM readout C q (dC = dnum q^T, 2 B S nh hd^2 a block, +);
  the q . n normaliser of the forward above, run twice under remat (-);
  and the sLSTM's first step, whose recurrent input is the zero initial
  state: autograd forms no gradient for it, JAX's scan does (one
  (B nh, hd) x (hd, 4 hd) product a block, -). None of them is work the
  port adds.
* The meta route: a kernel wrapper given meta tensors charges the
  kernel's declared cost and launches nothing; CPU tensors take the plain
  version and charge nothing; the caller's tensors are not touched.
* The cost runs on every main-path configuration (flat dense, int8 + EF,
  gossip, hierarchical, elastic, async), DeepSeekMoE's router count, and
  the finite guard and robust aggregation, costed as a clean step (the
  guard's bytes exact; the bytes of JAX's ``where`` it leaves out
  printed); a step whose loss reads a value on the host has none.
* The in-place flat mix's argument, output and alias bytes are exact;
  the byte model's rules (views, gathers, scatters) on single ops; the
  matmul flops equal ``torch.profiler``'s on a real CPU step; and
  ``launch/train.py --obs-cost`` writes a manifest ``jit_cost`` that
  ``tools/check_telemetry.py`` accepts, with ``--robust`` and
  ``--finite-guard`` too.
"""
import contextlib
import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.roofline.hlo_cost import jit_cost as jjit_cost  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    AsyncConfig,
    CommConfig,
    ElasticConfig,
    MAvgConfig,
    ObsConfig,
    RobustConfig,
    TopologyConfig,
    TrainConfig,
    get_config,
)
from repro_torch.core import meta as core_meta  # noqa: E402
from repro_torch.core.meta import make_meta_step  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.data import lm_batch_fn  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_meta as fm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.roofline.cost import (  # noqa: E402
    jit_cost,
    profiled_matmul_flops,
)
from repro_torch.topology import make_topology  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16
ARCHS = ["qwen3-1.7b", "hymba-1.5b", "xlstm-350m", "deepseek-moe-16b",
         "hubert-xlarge", "internvl2-76b"]


def _jax_inputs(arch):
    jcfg = jget_config(arch).reduced()
    params = jax.eval_shape(lambda k: japi.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    batch = jax.eval_shape(lambda k: japi.make_batch(k, jcfg, B, S),
                           jax.random.PRNGKey(1))
    return jcfg, params, batch


def _port_inputs(arch, grad=False):
    cfg = get_config(arch).reduced()
    params = api.init_params(None, cfg, "meta")
    if grad:
        params = tree_map(lambda x: x.requires_grad_(True), params)
    batch = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in api.batch_shapes(cfg, B, S).items()}
    return cfg, params, batch


def _xlstm_normaliser_dots(cfg) -> int:
    """The flops of JAX's q . n dots in the forward: 2 B S d_inner a
    mLSTM block."""
    mlstm = cfg.num_layers // cfg.slstm_every * (cfg.slstm_every - 1)
    return 2 * B * S * cfg.ssm_expand * cfg.d_model * mlstm


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_equal_jax(arch):
    jcfg, jparams, jbatch = _jax_inputs(arch)
    want = jjit_cost(lambda p, b: japi.forward(p, jcfg, b)[0], jparams,
                     jbatch).flops
    cfg, params, batch = _port_inputs(arch)
    got = jit_cost(lambda p, b: api.forward(p, cfg, b)[0], params,
                   batch).flops
    pinned = -_xlstm_normaliser_dots(cfg) if cfg.family == "ssm" else 0
    assert got - want == pinned
    if arch == "qwen3-1.7b":
        assert got == 84_934_656


def _xlstm_gradient_gap(cfg) -> int:
    """The port's gradient flops less JAX's for the xLSTM config (see the
    module docstring): + the dC outer products, - the normaliser dots of
    the forward and its recompute, - the sLSTM's first recurrent step."""
    G = cfg.num_layers // cfg.slstm_every
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    hd, hd_s = d_in // nh, cfg.d_model // nh
    outer = 2 * B * S * nh * hd * hd * G * (cfg.slstm_every - 1)
    first = 2 * B * nh * hd_s * 4 * hd_s * G
    return outer - 2 * _xlstm_normaliser_dots(cfg) - first


GRAD_ARCHS = ["qwen3-1.7b", "deepseek-moe-16b", "hymba-1.5b", "xlstm-350m"]


@pytest.mark.parametrize("arch,policy", [
    pytest.param(a, p, id=a if p == "everything" else f"{a}-{p}")
    for p in ("everything", "full", "dots") for a in GRAD_ARCHS])
def test_gradient_flops_equal_jax_under_the_everything_policy(arch, policy):
    """Under each policy, JAX and the port set to it (the test keeps its
    name: it held JAX's ``everything`` alone before the port had remat;
    that case keeps its id, the bare architecture)."""
    from repro_torch.models import transformer

    jcfg, jparams, jbatch = _jax_inputs(arch)
    saved = jtransformer.REMAT_POLICY, transformer.REMAT_POLICY
    try:
        jtransformer.set_remat_policy(policy)
        transformer.set_remat_policy(policy)
        want = jjit_cost(jax.grad(
            lambda p, b: japi.loss_fn(p, jcfg, b)[0]), jparams,
            jbatch).flops
        cfg, params, batch = _port_inputs(arch, grad=True)

        def grads(p, b):
            loss = api.loss_fn(p, cfg, b)[0]
            return torch.autograd.grad(loss, tree_leaves(p),
                                       allow_unused=True)

        got = jit_cost(grads, params, batch).flops
    finally:
        jtransformer.REMAT_POLICY, transformer.REMAT_POLICY = saved
    pinned = 0
    if cfg.family == "hybrid":  # dL/dh of y = h C, an outer product
        pinned = (2 * B * (S + cfg.meta_tokens) * cfg.ssm_expand
                  * cfg.d_model * cfg.ssm_state * cfg.num_layers)
    if cfg.family == "ssm":
        pinned = _xlstm_gradient_gap(cfg)
        assert pinned == 3_866_624  # the gap found op by op
    assert got - want == pinned
    if arch == "qwen3-1.7b":
        assert got == {"everything": 254_803_968, "dots": 255_852_544,
                       "full": 314_572_800}[policy]


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------


def _planes(*shapes, device="cpu"):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=gen).to(device) for s in shapes]


def test_meta_route_charges_the_declared_cost_and_launches_nothing():
    ops.reset_launch_counts()
    w, v, a = _planes((64, 128), (64, 128), (64, 128))
    learners = torch.empty((4, 64, 128))
    cpu = ops.fused_momentum_broadcast(w, v, a, mu=0.7, num_learners=4)

    def mix(w, v, a, lrn):
        return ops.fused_momentum_broadcast(
            w, v, a, mu=0.7, num_learners=4, w_out=w, v_out=v,
            learners_out=lrn)

    jc = jit_cost(mix, w, v, a, learners)
    assert jc.kernel_calls == {"fused_momentum_broadcast": 1}
    declared = fm.cost(w, v, a, 0.7, 1.0, 4, torch.float32)
    assert declared.nbytes == (5 + 4) * w.numel() * 4
    assert jc.hbm_bytes == declared.nbytes and jc.flops == 0.0
    # the caller's planes are untouched, and nothing was launched
    w2, v2, a2 = _planes((64, 128), (64, 128), (64, 128))
    assert all(torch.equal(x, y) for x, y in ((w, w2), (v, v2), (a, a2)))
    assert all(n == 0 for n in ops.launch_counts().values())
    assert torch.equal(cpu[0], fm.fused_momentum_broadcast_plain(
        w, v, a, 0.7, 1.0, 4, torch.float32)[0])


def test_cpu_tensors_never_take_the_meta_route():
    calls = []

    class Counter:
        def uncounted(self):
            calls.append("uncounted")
            return contextlib.nullcontext()

        def charge(self, cost, out):
            calls.append(cost)

    w, g = _planes((16, 128), (16, 128))
    with kcost.counting(Counter()):
        ops.sgd_apply(w, g, 0.1, out=w)
        ops.quantize(g, lambda shape: torch.rand(shape))
    assert calls == []
    assert ops._route(w, "plain", "cuda", "cost") == "plain"
    meta = ops._route(w.to("meta"), "plain", "cuda", "cost")
    assert callable(meta) and meta not in ("plain", "cuda")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._route(SimpleNamespace(device=torch.device("xla")), "plain",
                   "cuda", "cost")


def test_flash_attention_declares_its_visible_pairs():
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, sliding_window=5, prefix_global=3),
               dict(causal=True, kv_len=9)):
        q = torch.empty((2, 33, 4, 64), dtype=torch.bfloat16, device="meta")
        k = torch.empty((2, 33, 2, 64), dtype=torch.bfloat16, device="meta")
        mask = fa.visible(torch.arange(33), torch.arange(33),
                          causal=kw.get("causal", True),
                          sliding_window=kw.get("sliding_window", 0),
                          prefix_global=kw.get("prefix_global", 0),
                          kv_len=kw.get("kv_len", 33))
        pairs = int(mask.expand(33, 33).sum())
        c = fa.cost(q, k, k, **kw)
        assert c.flops == 4 * 2 * 4 * 64 * pairs and c.unit == "bf16"
        assert c.nbytes == 2 * (2 * q.numel() + 2 * k.numel())
    jc = jit_cost(lambda q, k, v: ops.flash_attention(q, k, v), q, k, k)
    assert jc.kernel_calls == {"flash_attention": 1}
    assert jc.flops == fa.cost(q, k, k).flops > 0  # tensor-core flops
    q32 = torch.empty((1, 8, 2, 64), device="meta")
    assert fa.cost(q32, q32, q32).unit == "tf32x3"


# ---------------------------------------------------------------------------
# the cost on the main path's configurations
# ---------------------------------------------------------------------------

MAIN_PATH = {
    "flat_dense": MAvgConfig(num_learners=2, k_steps=2),
    "flat_int8_ef": MAvgConfig(num_learners=2, k_steps=2,
                               comm=CommConfig(scheme="int8")),
    "gossip": MAvgConfig(num_learners=4, k_steps=2, comm=CommConfig(
        scheme="int8"), topology=TopologyConfig(
            kind="gossip", graph="one_peer_exponential")),
    "hierarchical_elastic": MAvgConfig(
        num_learners=4, k_steps=2, topology=TopologyConfig(
            kind="hierarchical", groups=2, outer_every=1,
            inner_comm=CommConfig(scheme="int8"),
            elastic=ElasticConfig(period=4, drop_frac=0.25))),
    "async": MAvgConfig(num_learners=4, k_steps=2, topology=TopologyConfig(
        kind="async", server=AsyncConfig(staleness=3,
                                         step_time=(1, 1, 2, 2)))),
}
EXPECTED_CALLS = {
    "flat_dense": {"sgd_apply": 4, "fused_momentum_broadcast": 1},
    "flat_int8_ef": {"sgd_apply": 4, "pack_update": 1,
                     "fused_momentum_broadcast": 1},
    "gossip": {"sgd_apply": 8, "pack_compress": 1,
               "neighbor_mix_stepped": 1, "block_momentum": 1},
}


def _trainer(mcfg, arch="qwen3-1.7b", **obs):
    cfg = get_config(arch).reduced()
    tc = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=B, seq_len=S,
                     meta_steps=1, obs=ObsConfig(**obs))
    bf = lm_batch_fn(cfg, mcfg.num_learners, mcfg.k_steps, B, S,
                     device="cpu")
    return Trainer(tc, lambda p, b: api.loss_fn(p, cfg, b),
                   lambda g: api.init_params(g, cfg, "cpu"), bf,
                   device="cpu")


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_the_step_is_costed_on_every_main_path_configuration(name):
    tr = _trainer(MAIN_PATH[name])
    before = [t.clone() for t in tree_leaves(tr.state.learners)]
    tr._cost(tr.batch_fn(tr._data_generator(0), 0), 0.01)
    jc = tr.jit_cost
    assert jc is not None and jc.flops > 0 and jc.hbm_bytes > 0
    assert jc.alias_bytes > 0 and jc.peak_state_bytes > jc.arg_bytes
    if name in EXPECTED_CALLS:
        assert jc.kernel_calls == EXPECTED_CALLS[name]
    assert sum(jc.kernel_calls.values()) >= 1
    # the live state was not stepped
    assert tr.state.step == 0
    assert all(torch.equal(x, y) for x, y in
               zip(before, tree_leaves(tr.state.learners)))


def test_moe_router_count_is_costed_through_bincount():
    tr = _trainer(MAvgConfig(num_learners=2, k_steps=1),
                  arch="deepseek-moe-16b")
    tr._cost(tr.batch_fn(tr._data_generator(0), 0), 0.01)
    assert tr.jit_cost is not None and tr.jit_cost.flops > 0
    idx = torch.empty((7,), dtype=torch.int64, device="meta")
    out = jit_cost(lambda i: torch.bincount(i, minlength=5), idx)
    assert out.out_bytes == 5 * 8
    with pytest.raises(ValueError, match="minlength"):
        jit_cost(lambda i: torch.bincount(i), idx)


def test_a_step_that_reads_values_on_the_host_has_no_cost():
    """A loss that reads a value on the host (``float``) cannot be run on
    meta copies: the Trainer's cost is None, best-effort as JAX's. (The
    finite guard and robust aggregation no longer read values in a costed
    step: see the next test.)"""
    tr = _trainer(MAvgConfig(num_learners=2, k_steps=1))
    inner = tr.loss_fn

    def reading(p, b):
        loss, aux = inner(p, b)
        assert float(loss.detach()) == float(loss.detach())  # a host read
        return loss, aux

    tr.loss_fn = reading
    tr._step_fn = make_meta_step(reading, tr.mcfg, topology=tr._topology)
    tr._cost(tr.batch_fn(tr._data_generator(0), 0), 0.01)
    assert tr.jit_cost is None


@pytest.mark.parametrize("name", ["guard", "robust", "robust_guard"])
def test_guarded_and_robust_steps_are_costed(name):
    """The finite guard and robust aggregation (trimmed mean or median,
    the norm clip, the anomaly scores) are costed as a clean step: the
    guard's ``isfinite`` passes are charged and its read gives every
    learner finite; the clip's factors and the Gram matrix stay on the
    meta device and no learner is clipped. Neither writes a learner, where
    JAX's ``where`` reads and writes every learner plane and w~ (the
    bytes printed: the port's count leaves them out)."""
    rcfg = RobustConfig(estimator="median" if name == "robust_guard"
                        else "trimmed", trim=1, clip_mult=3.0,
                        clip_window=2, score=True)
    L = 2 if name == "guard" else 4
    cfg = MAvgConfig(num_learners=L, k_steps=1,
                     finite_guard=name != "robust",
                     robust=None if name == "guard" else rcfg)
    plain = dataclasses.replace(cfg, finite_guard=False, robust=None)
    costs = []
    for c in (cfg, plain):
        tr = _trainer(c)
        before = [t.clone() for t in tree_leaves(tr.state.learners)]
        tr._cost(tr.batch_fn(tr._data_generator(0), 0), 0.01)
        assert tr.jit_cost is not None
        costs.append(tr.jit_cost)
        # the live state was not touched
        assert all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(tr.state.learners)))
    got, base = costs
    rows = tr.state.spec.rows
    n = rows * 128
    calls = {"sgd_apply": L, "fused_momentum_broadcast": 1}
    if cfg.robust is not None:
        calls["robust_reduce"] = 1
    assert got.kernel_calls == calls
    # the Gram matrix of the displacements: one (L, w) x (w, L) product a
    # window, in f32
    gram = 2 * L * L * n if cfg.robust is not None else 0
    assert got.flops == base.flops + gram
    if name == "guard":
        # the guard adds its isfinite passes over the learner planes (the
        # mask alone, costed on its own: ``isfinite`` as ATen decomposes
        # it, reading every value at least once) and writes nothing
        isz = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                          ).element_size()
        mask = jit_cost(core_meta._learner_finite_mask,
                        tr.state.learners).hbm_bytes
        assert got.hbm_bytes - base.hbm_bytes == mask >= L * n * isz
        where = 2 * L * n * isz + n * 4
        print(f"finite guard: {mask:.0f} bytes charged; JAX's where over "
              f"the learners moves {where} more (reads and writes the {L} "
              f"learner planes, reads w~)")


def test_in_place_flat_mix_bytes_are_exact():
    L, rows = 4, 48
    gp, v = _planes((rows, 128), (rows, 128))
    lrn, = _planes((L, rows, 128))
    topo = make_topology(MAvgConfig(num_learners=L, k_steps=1))
    plane = rows * 128 * 4

    def mix(gp, v, lrn):
        with torch.no_grad():
            return topo.mix(lrn, gp, v, None, None, step=0)

    jc = jit_cost(mix, gp, v, lrn)
    assert jc.arg_bytes == (2 + L) * plane
    assert jc.alias_bytes == (2 + L) * plane
    # and three f32 0-d metrics: consensus_dist, displacement_norm, v_norm
    assert jc.out_bytes == (2 + L) * plane + 3 * 4
    assert jc.kernel_calls == {"fused_momentum_broadcast": 1}
    # the mean plane lives beside the state: the peak is one plane above
    assert jc.temp_bytes >= plane
    assert jc.peak_state_bytes == (jc.arg_bytes + jc.out_bytes
                                   + jc.temp_bytes - jc.alias_bytes)
    # out of place, the outputs are fresh planes and nothing aliases
    fresh = jit_cost(lambda gp, v, lrn: ops.fused_momentum_broadcast(
        gp, v, lrn.mean(0), mu=0.7, num_learners=L), gp, v, lrn)
    assert fresh.alias_bytes == 0 and fresh.out_bytes == (2 + L) * plane
    declared = jit_cost(lambda *s: ops.fused_momentum_broadcast(
        s[0], s[1], s[2].mean(0), mu=0.7, num_learners=L, w_out=s[0],
        v_out=s[1], learners_out=s[2]), gp, v, lrn, in_place=(0, 1, 2))
    assert declared.alias_bytes == (2 + L) * plane


def test_byte_model_rules_on_single_ops():
    x = torch.empty((64, 32))
    idx = torch.zeros((16,), dtype=torch.int64)
    src = torch.empty((16, 32))
    nb = 64 * 32 * 4
    assert jit_cost(lambda x: x.view(32, 64).t(), x).hbm_bytes == 0
    assert jit_cost(lambda x: x * 2, x).hbm_bytes == 2 * nb
    assert jit_cost(lambda x, i: x.index_select(0, i), x,
                    idx).hbm_bytes == 2 * 16 * 32 * 4
    assert jit_cost(lambda x, i, s: x.index_add(0, i, s), x, idx,
                    src).hbm_bytes == 3 * 16 * 32 * 4
    add = jit_cost(lambda x, y: x.add_(y), x, torch.empty((64, 32)))
    assert add.hbm_bytes == 3 * nb and add.alias_bytes == nb
    assert add.out_bytes == nb and add.temp_bytes == 0
    mm = jit_cost(lambda a, b: a @ b, torch.empty((8, 16)),
                  torch.empty((16, 4)))
    assert mm.flops == 2 * 8 * 16 * 4
    assert mm.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_matmul_flops_equal_the_profilers_on_a_real_step():
    """The step's blocks run under the default remat (``full``): a
    block's recompute stops once its last saved input is back (the
    checkpoint's early stop), inside the autograd wrapper of the block's
    last product (the MLP's down projection), before its kernel. The
    profiler has recorded that product by then; the counter, below
    autograd, sees what ran. So the two are held equal with the early
    stop off (every recomputed op runs), and with it on the profiler
    counts one down projection a block and a local step more."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    tr = _trainer(MAIN_PATH["flat_dense"])
    cfg, mcfg = tr.cfg.model, tr.mcfg
    batch = tr.batch_fn(tr._data_generator(0), 0)

    def step(s, b):
        return tr._step_fn(s, b, lr=0.01)

    jc = jit_cost(step, tr.state, batch, in_place=(0,))
    with set_checkpoint_early_stop(False):
        whole = jit_cost(step, tr.state, batch, in_place=(0,))
        ops.reset_launch_counts()
        (state, _), flops = profiled_matmul_flops(step, tr.state, batch)
    assert flops == whole.flops > 0
    assert state.step == 1
    (state, _), stopped = profiled_matmul_flops(step, state, batch)
    down = 2 * B * S * cfg.d_ff * cfg.d_model
    steps = mcfg.num_learners * mcfg.k_steps * cfg.num_layers
    assert whole.flops - jc.flops == stopped - jc.flops == steps * down


def _check_telemetry():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", ROOT / "tools" / "check_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    pytest.param([], id="plain"),
    pytest.param(["--robust", "trimmed", "--robust-clip", "3"], id="robust"),
    pytest.param(["--finite-guard"], id="finite_guard")])
def test_obs_cost_launcher_writes_a_checked_jit_cost(tmp_path, capsys,
                                                     flags):
    run_dir = tmp_path / "run"
    learners = "4" if "--robust" in flags else "2"
    launch_train.main(["--device", "cpu", "--learners", learners, "--k",
                       "2", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--obs-sink", "jsonl", "--run-dir", str(run_dir),
                       "--obs-cost"] + flags)
    assert "final train loss" in capsys.readouterr().out
    recs = [json.loads(line) for line in open(run_dir / "run.jsonl")]
    cost = recs[0]["jit_cost"]
    assert recs[0]["kind"] == "manifest"
    assert cost["flops"] > 0 and cost["alias_bytes"] > 0
    assert cost["peak_state_bytes"] == (cost["arg_bytes"]
                                        + cost["out_bytes"]
                                        + cost["temp_bytes"]
                                        - cost["alias_bytes"])
    ct = _check_telemetry()
    schema = ct.load_schema(str(ROOT / "tools" / "telemetry_schema.json"))
    with open(run_dir / "run.jsonl") as f:
        assert ct.check_stream(f, schema) == []
    assert np.isfinite([r["loss"] for r in recs if r["kind"] == "step"]).all()
