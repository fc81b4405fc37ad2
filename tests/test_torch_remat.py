"""Block remat of the port's transformer stacks
(``models/transformer.py::set_remat_policy``, ``models/layers.py::remat``),
JAX's ``jax.checkpoint(policy=REMAT_POLICY)`` over its layer scan.

* The default is ``full``, JAX's (``nothing_saveable``); an unknown name
  raises KeyError, as JAX's dict lookup does.
* Under ``full``, ``dots`` and ``everything`` the loss, the MoE aux loss
  and every gradient of the reduced dense, MoE (a dense first layer, then
  MoE blocks: the bf16 top-k picks the same experts when recomputed) and
  VLM configs are bitwise the ones of the loop without remat (the blocks
  called directly), on the CPU.
* Remat costs memory and flops as it should on the meta device
  (``roofline.cost.jit_cost``, which counts the recompute): the
  temporaries fall from ``everything`` to ``dots`` to ``full`` and the
  flops rise; ``tests/test_torch_cost.py`` holds the flops to JAX's under
  each policy.
* ``dots`` keeps the outputs of ``aten.mm`` and ``aten.addmm`` (matmuls
  with no batch dims) and recomputes ``aten.bmm`` (attention).
* Serving is untouched: with no input that requires a gradient, no
  checkpoint is made.
* ``launch/dryrun.py --remat`` sets the policy.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.roofline.cost import jit_cost  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

POLICIES = ("full", "dots", "everything")


@pytest.fixture
def policy_restored():
    saved = transformer.REMAT_POLICY
    yield
    transformer.REMAT_POLICY = saved


def test_default_policy_is_jax_default_and_names_are_jax(policy_restored):
    import jax

    from repro.models import transformer as jtransformer

    assert transformer.REMAT_POLICY == "full"
    assert (jtransformer.REMAT_POLICY
            is jax.checkpoint_policies.nothing_saveable)
    for name in POLICIES:
        transformer.set_remat_policy(name)
        jtransformer.set_remat_policy(name)
        assert transformer.REMAT_POLICY == name
    jtransformer.set_remat_policy("full")
    with pytest.raises(KeyError):
        transformer.set_remat_policy("nothing_saveable")
    with pytest.raises(KeyError):
        jtransformer.set_remat_policy("nothing_saveable")


def _loss_and_grads(cfg, params, batch):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss, aux = api.loss_fn(p, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux["aux_loss"].detach(), grads


def _no_remat(monkeypatch):
    """The forward with the blocks called directly (the loop before
    remat)."""
    monkeypatch.setattr(L, "remat", lambda fn, *args, policy: fn(*args))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "internvl2-76b"])
def test_gradients_are_bitwise_the_no_remat_ones(arch, policy,
                                                 policy_restored,
                                                 monkeypatch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg, "cpu")
    batch = api.make_batch(gen, cfg, 2, 16)
    transformer.set_remat_policy(policy)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("context_fn"))
        return real(*a, **kw)

    monkeypatch.setattr(L, "checkpoint", counted)
    got = _loss_and_grads(cfg, params, batch)
    # one checkpoint a block under full and dots, none under everything
    assert len(calls) == (0 if policy == "everything" else cfg.num_layers)
    monkeypatch.undo()
    _no_remat(monkeypatch)
    want = _loss_and_grads(cfg, params, batch)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if cfg.num_experts:
        assert float(got[1]) > 0  # the aux loss came through the checkpoint
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_remat_trades_temporaries_for_flops_on_the_meta_device(
        arch, policy_restored):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4,
                              first_dense_layers=min(
                                  get_config(arch).first_dense_layers, 1))
    params = tree_map(lambda x: x.requires_grad_(True),
                      api.init_params(None, cfg, "meta"))
    batch = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in api.batch_shapes(cfg, 8, 256).items()}

    def grads(p, b):
        loss = api.loss_fn(p, cfg, b)[0]
        return torch.autograd.grad(loss, tree_leaves(p))

    cost = {}
    for name in POLICIES:
        transformer.set_remat_policy(name)
        cost[name] = jit_cost(grads, params, batch)
    temp = {k: c.temp_bytes for k, c in cost.items()}
    flops = {k: c.flops for k, c in cost.items()}
    print(f"{arch}: temporaries {temp}, flops {flops}")
    assert temp["full"] < temp["dots"] < temp["everything"], temp
    assert flops["full"] > flops["dots"] > flops["everything"], flops


def test_dots_keeps_the_products_with_no_batch_dims():
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default):
        assert L._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default,
               aten._softmax.default):
        assert L._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("policy", POLICIES)
def test_serving_makes_no_checkpoint(policy, policy_restored, monkeypatch):
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = api.init_params(gen, cfg, "cpu")
    batch = api.make_batch(gen, cfg, 2, 8)
    want, _ = api.forward(params, cfg, batch)
    transformer.set_remat_policy(policy)

    def refuse(*a, **kw):
        raise AssertionError("a checkpoint while serving")

    monkeypatch.setattr(L, "checkpoint", refuse)
    with torch.no_grad():
        got, _ = api.forward(params, cfg, batch)
        logits, _ = api.prefill(params, cfg, {"tokens": batch["tokens"]}, 8)
    # grad mode on, but no input requires a gradient
    again, _ = api.forward(params, cfg, batch)
    assert torch.equal(got, want) and torch.equal(again, want)
    # the head on the last position alone rounds apart from the whole
    # row's product
    torch.testing.assert_close(logits, want[:, -1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_dryrun_cli_sets_the_policy(policy, policy_restored, monkeypatch):
    from repro_torch.launch import dryrun
    from repro_torch.launch import dryrun_lib as D

    seen = []

    def run_one(arch, shape, mesh, **kw):
        seen.append(transformer.REMAT_POLICY)
        return {"skipped": True, "reason": "stub", "arch": arch,
                "shape": shape, "mesh": mesh, "mode": "faithful"}

    monkeypatch.setattr(D, "run_one", run_one)
    monkeypatch.setattr(D, "save_result", lambda res, algorithm: "stub")
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                        "--mesh", "single", "--remat", policy]) == 0
    assert seen == [policy]
