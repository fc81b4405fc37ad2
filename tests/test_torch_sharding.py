"""The port's sharding rules and placement specs against the JAX
package's (``repro.sharding.rules``, ``repro.launch.specs``).

JAX's ``AbstractMesh`` raises on this jax (``tests/test_sharding.py``
does not collect), and its rules read only ``mesh.shape[axis]``, so JAX
is called with a stub mesh whose ``.shape`` is a dict. Its spec functions
wrap each spec in a ``NamedSharding``, which needs a real mesh: the tests
put a stand-in holding the spec in its place (``monkeypatch``; nothing of
``repro`` is edited). The port's specs are ``repro_torch.sharding.Spec``
tuples, compared entry for entry with JAX's ``PartitionSpec``s.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import dryrun_lib as jdl  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding import make_param_specs as jmake_param_specs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    Spec,
    add_learner_axis,
    make_param_specs,
    named,
)
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

MESHES = [(16, 16), (32, 8), (4, 2)]
MULTI = (2, 32, 8)


class StubMesh:
    """What JAX's rules read of a mesh: ``.shape``, a dict."""

    def __init__(self, shape, names=("data", "model")):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)
        self.size = 1
        for n in shape:
            self.size *= n


class NS:
    """Stand-in for ``jax.sharding.NamedSharding`` (which needs devices)."""

    def __init__(self, mesh, spec):
        self.spec = spec


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _both(shape):
    names = _names(shape)
    return StubMesh(shape, names), meshlib.AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jspecs.abstract_params(jbase.get_config(arch))


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return tspecs.abstract_params(tbase.get_config(arch))


def _jleaves(specs):
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))


def _same(jspec, tspec):
    assert isinstance(tspec, Spec)
    assert tuple(jspec) == tuple(tspec), (jspec, tspec)


@pytest.fixture(scope="module")
def fake_group():
    meshlib.start_fake_group(8)
    yield
    dist.destroy_process_group()


@pytest.fixture
def stub_named_sharding(monkeypatch):
    monkeypatch.setattr(jspecs, "NamedSharding", NS)
    monkeypatch.setattr(jdl, "NamedSharding", NS)


# ---------------------------------------------------------------------------
# the eight cases of tests/test_sharding.py, on the port
# ---------------------------------------------------------------------------

MESH16 = meshlib.AbstractMesh((16, 16), ("data", "model"))


def _specs(arch, **kw):
    params = _tparams(arch)
    return params, make_param_specs(params, MESH16, **kw)


def test_llama_attention_head_parallel():
    _, specs = _specs("llama3-405b")
    assert specs["blocks"]["attn"]["wq"] == Spec(None, None, "model", None)
    assert specs["blocks"]["attn"]["wo"] == Spec(None, "model", None, None)
    assert specs["blocks"]["mlp"]["wi"] == Spec(None, None, None, "model")
    assert specs["blocks"]["mlp"]["wo"] == Spec(None, "model", None)
    assert specs["embed"]["embedding"] == Spec("model", None)


def test_qwen2_head_fallback():
    _, specs = _specs("qwen2-7b")
    assert specs["blocks"]["attn"]["wq"] == Spec(None, "model", None, None)
    assert specs["blocks"]["attn"]["wo"] == Spec(None, None, None, "model")


def test_moe_expert_parallel():
    _, specs = _specs("kimi-k2-1t-a32b")
    assert specs["blocks"]["moe"]["w_in"] == Spec(None, "model", None, None,
                                                  None)
    assert specs["blocks"]["moe"]["w_out"] == Spec(None, "model", None, None)
    assert specs["blocks"]["moe"]["router"] == Spec(None, None, "model")


def test_norms_replicated():
    _, specs = _specs("qwen3-1.7b")
    assert specs["final_norm"]["scale"] == Spec(None)
    assert specs["blocks"]["attn_norm"]["scale"] == Spec(None, None)


def test_fsdp_second_axis():
    _, specs = _specs("llama3-405b", fsdp_axis="data")
    assert specs["blocks"]["attn"]["wq"] == Spec(None, "data", "model", None)


def test_learner_axis_prepend():
    _, specs = _specs("qwen3-1.7b")
    lspecs = add_learner_axis(specs, "data")
    assert lspecs["blocks"]["attn"]["wq"] == Spec("data", None, None,
                                                  "model", None)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_every_leaf_has_spec(arch):
    params, specs = _specs(arch)
    assert tree_paths(params) == tree_paths(specs)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_divisibility(arch):
    params, specs = _specs(arch, fsdp_axis="data")
    for leaf, spec in zip(tree_leaves(params), tree_leaves(specs)):
        for dim, ax in enumerate(spec):
            if ax is not None:
                assert leaf.shape[dim] % 16 == 0, (arch, spec)


# ---------------------------------------------------------------------------
# leaf for leaf against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [None, "data"], ids=["tp", "tp+fsdp"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_specs_equal_jax(arch, shape, fsdp):
    jmesh, tmesh = _both(shape)
    jleaves = jax.tree_util.tree_leaves_with_path(_jparams(arch))
    js = _jleaves(jmake_param_specs(_jparams(arch), jmesh, fsdp_axis=fsdp))
    ts = make_param_specs(_tparams(arch), tmesh, fsdp_axis=fsdp)
    assert [jax.tree_util.keystr(p, simple=True, separator="/")
            for p, _ in jleaves] == tree_paths(ts)
    assert len(js) == len(tree_leaves(ts))
    for j, t in zip(js, tree_leaves(ts)):
        _same(j, t)


def _state_pairs(jstate, tstate):
    """(JAX leaf, port leaf) over the state's tensor fields (the step is a
    device int32 in JAX and a host int in the port)."""
    out = []
    for f in ("global_params", "momentum", "learners", "comm_residual",
              "topo"):
        j = jax.tree.leaves(getattr(jstate, f),
                            is_leaf=lambda x: isinstance(x, (P, NS)))
        t = _tree_specs(getattr(tstate, f))
        assert len(j) == len(t), f
        out += list(zip(j, t))
    return out


def _tree_specs(tree):
    if tree is None:
        return []
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _tree_specs(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _tree_specs(v)]
    return []


STATE_CASES = [
    # (arch, mesh, packed, tp_mode, hierarchical, comm, topology)
    ("qwen3-1.7b", (32, 8), True, "megatron", False, "dense", "flat"),
    ("qwen3-1.7b", (4, 2), True, "megatron", False, "dense", "flat"),
    ("qwen3-1.7b", (16, 16), True, "dp", False, "dense", "flat"),
    ("qwen3-1.7b", (32, 8), False, "megatron", False, "dense", "flat"),
    ("qwen3-1.7b", (32, 8), False, "fsdp", False, "int8", "flat"),
    ("qwen3-1.7b", (32, 8), False, "dp", False, "dense", "flat"),
    ("qwen3-1.7b", (32, 8), True, "megatron", False, "int8", "gossip"),
    ("qwen3-1.7b", (32, 8), False, "megatron", False, "dense", "gossip"),
    ("deepseek-moe-16b", (32, 8), True, "megatron", False, "dense", "flat"),
    ("deepseek-moe-16b", MULTI, False, "megatron", True, "dense", "flat"),
    ("llama3-405b", MULTI, True, "megatron", False, "dense", "flat"),
    ("hymba-1.5b", (16, 16), False, "megatron", False, "dense", "flat"),
]


def _mcfgs(mesh, packed, tp_mode, hierarchical, comm, topology):
    L = (mesh.size if tp_mode == "dp"
         else meshlib.num_learners(mesh, hierarchical=hierarchical))
    kw = dict(num_learners=L, k_steps=2, packed=packed)
    return tuple(
        b.MAvgConfig(**kw, comm=b.CommConfig(scheme=comm),
                     topology=b.TopologyConfig(kind=topology))
        for b in (jbase, tbase))


@pytest.mark.parametrize("case", STATE_CASES,
                         ids=lambda c: "-".join(map(str, c[:4] + c[5:])))
def test_state_shardings_and_arg_bytes_equal_jax(case, stub_named_sharding):
    arch, shape, packed, tp_mode, hier, comm, topology = case
    jmesh, tmesh = _both(shape)
    jm, tm = _mcfgs(tmesh, packed, tp_mode, hier, comm, topology)
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    jsh = jspecs.state_shardings(jcfg, jm, jmesh, hierarchical=hier,
                                 tp_mode=tp_mode)
    tsh = tspecs.state_shardings(tcfg, tm, tmesh, hierarchical=hier,
                                 tp_mode=tp_mode)
    pairs = _state_pairs(jsh, tsh)
    assert pairs
    for j, t in pairs:
        _same(j.spec, t)
    # per-device argument bytes: JAX's arithmetic over JAX's specs
    jstate = jspecs.abstract_state(jcfg, jm)
    fields = ("global_params", "momentum", "learners", "comm_residual",
              "topo")
    jbytes = jdl._sharded_arg_bytes(
        tuple(getattr(jstate, f) for f in fields),
        tuple(getattr(jsh, f) for f in fields), jmesh)
    tstate = tspecs.abstract_state(tcfg, tm)
    assert tspecs.sharded_arg_bytes(tstate, tsh, tmesh) == jbytes


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
@pytest.mark.parametrize("shape", [(32, 8), MULTI],
                         ids=lambda s: "x".join(map(str, s)))
def test_serve_and_cache_specs_equal_jax(arch, shape, stub_named_sharding):
    jmesh, tmesh = _both(shape)
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    js = _jleaves(jax.tree.map(lambda s: s.spec,
                               jspecs.serve_param_shardings(jcfg, jmesh),
                               is_leaf=lambda x: isinstance(x, NS)))
    ts = tree_leaves(tspecs.serve_param_shardings(tcfg, tmesh))
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        _same(j, t)
    pre = jbase.INPUT_SHAPES["prefill_32k"]
    jp = jspecs.prefill_input_shardings(jcfg, jmesh, pre)
    tp = tspecs.prefill_input_shardings(tcfg, tmesh, pre)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        _same(jp[k].spec, tp[k])
    if tcfg.is_encoder_only:
        return
    dec = jbase.INPUT_SHAPES["decode_32k"]
    jc = jax.tree.leaves(jspecs.cache_shardings(jcfg, jmesh, dec),
                         is_leaf=lambda x: isinstance(x, NS))
    tc = _tree_specs(tspecs.cache_shardings(tcfg, tmesh, dec))
    assert len(jc) == len(tc)
    for j, t in zip(jc, tc):
        _same(j.spec, t)
    _same(jspecs.decode_token_sharding(jmesh, dec).spec,
          tspecs.decode_token_sharding(tmesh, dec))
    # the port's cache has JAX's structure, so each spec meets its tensor
    jcache, _ = jspecs.decode_input_specs(jcfg, dec)
    tcache, _ = tspecs.decode_input_specs(tcfg, dec)
    assert [tuple(x.shape) for x in jax.tree.leaves(jcache)] == [
        tuple(x.shape) for x in _tree_tensors(tcache)]


def _tree_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tree_tensors(v)]
    return []


@pytest.mark.parametrize("shape", [(32, 8), MULTI],
                         ids=lambda s: "x".join(map(str, s)))
def test_mesh_axes_match_jax_meaning(shape):
    from repro.launch import mesh as jmesh

    sm, tm = _both(shape)
    for hier in (False, True):
        assert meshlib.learner_axes(tm, hierarchical=hier) == \
            jmesh.learner_axes(sm, hierarchical=hier)
        assert meshlib.num_learners(tm, hierarchical=hier) == \
            jmesh.num_learners(sm, hierarchical=hier)
        assert meshlib.fsdp_axes(tm, hierarchical=hier) == \
            jmesh.fsdp_axes(sm, hierarchical=hier)


# ---------------------------------------------------------------------------
# DTensor placements on a DeviceMesh (a fake group of 8 ranks)
# ---------------------------------------------------------------------------


def test_named_gives_dtensor_placements(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshlib.make_debug_mesh(4, 2)
    specs = {"a": Spec(None, "model"), "b": Spec(("data", "model")),
             "c": Spec(), "d": Spec("data", None, "model")}
    pl = named(specs, mesh)
    assert pl["a"] == (Replicate(), Shard(1))
    assert pl["b"] == (Shard(0), Shard(0))
    assert pl["c"] == (Replicate(), Replicate())
    assert pl["d"] == (Shard(0), Shard(2))
    x = tspecs.place(torch.empty((8, 6, 4), device="meta"), specs["d"], mesh)
    assert tuple(x.shape) == (8, 6, 4)
    assert tuple(x.to_local().shape) == (2, 6, 2)


def test_place_slices_this_ranks_piece(fake_group):
    mesh = meshlib.make_debug_mesh(4, 2)
    full = torch.arange(8 * 4, dtype=torch.float32).view(8, 4)
    x = tspecs.place(full, Spec("data", "model"), mesh)
    assert torch.equal(x.to_local(), full[:2, :2])  # rank 0's piece
