"""The yardstick and the reference against the port, on the CPU at a
reduced size: the model-FLOP count against ``torch.utils.flop_counter``
on the port's forward, and the frozen reference against the port's loss,
gradients and one meta step, both in float32."""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from benchlib import compare, inputs, ref_mavg, ref_transformer, yardstick  # noqa: E402,E501

SMALL = {
    "qwen3-1.7b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       head_dim=16, d_ff=96, vocab_size=200),
    "deepseek-moe-16b-l3": dict(num_layers=3, d_model=64, num_heads=4,
                                num_kv_heads=4, head_dim=16, d_ff=96,
                                vocab_size=200, num_experts=8, d_expert=24,
                                moe_top_k=2, num_shared_experts=2),
}
TRAFFIC = dict(learners=2, k_steps=2, batch=3, seq_len=16, learner_lr=0.05,
               momentum=0.7, meta_lr=1.0)


def small_config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return dict(cfg["model"], **SMALL[name], dtype=dtype)


def port_loss(cfg, params, tokens):
    from benchlib import program
    from repro_torch.models import api

    return api.loss_fn(params, program.model_config(cfg),
                       {"tokens": tokens, "labels": tokens})[0]


@pytest.mark.parametrize("name", list(SMALL))
def test_flop_count_is_the_forward_matmuls_and_half_the_scores(name):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = small_config(name)
    B, S = 2, 16
    params = inputs.make_params(cfg, 3, "cpu")
    tokens = inputs.make_batches(cfg, dict(TRAFFIC, batch=B, seq_len=S), 3,
                                 0, "cpu")["tokens"][0, 0]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        port_loss(cfg, params, tokens)
    ops = counter.get_flop_counts()["Global"]
    mm = sum(v for k, v in ops.items() if "bmm" not in str(k))
    bmm = sum(v for k, v in ops.items() if "bmm" in str(k))
    T = B * S
    full_scores = (cfg["num_layers"] * 2 * 2 * B * cfg["num_heads"] * S * S
                   * cfg["head_dim"])
    attention = yardstick.attention_flops_per_token(cfg, S) * T
    assert attention == full_scores / 2
    params_term = 2 * yardstick.active_matmul_params(cfg) * T
    if not cfg.get("num_experts"):
        assert bmm == full_scores
        assert mm == params_term
    else:
        # the port runs the routed experts over the capacity table; the
        # model count takes the top-k slots a token uses
        E, k, d, de = (cfg["num_experts"], cfg["moe_top_k"], cfg["d_model"],
                       cfg["d_expert"])
        moe_layers = cfg["num_layers"] - cfg["first_dense_layers"]
        per_slot = 2 * 3 * d * de * moe_layers
        table = E * ref_transformer.capacity(T, cfg)
        assert bmm == full_scores + per_slot * table
        assert mm + per_slot * T * k == params_term


@pytest.mark.parametrize("name", list(SMALL))
def test_reference_loss_and_gradients_equal_the_ports(name):
    cfg = small_config(name)
    tokens = inputs.make_batches(cfg, TRAFFIC, 5, 0, "cpu")["tokens"][0, 0]

    def grads(loss_fn):
        params = inputs.make_params(cfg, 5, "cpu")
        leaves = ref_mavg.leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        value = loss_fn(params)
        return value.detach(), torch.autograd.grad(value, leaves)

    ref_value, ref_grads = grads(
        lambda p: ref_transformer.loss(p, cfg, tokens, tokens))
    port_value, port_grads = grads(lambda p: port_loss(cfg, p, tokens))
    torch.testing.assert_close(port_value, ref_value, rtol=1e-6, atol=1e-6)
    for g_port, g_ref in zip(port_grads, ref_grads):
        torch.testing.assert_close(g_port, g_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(SMALL))
def test_reference_meta_steps_equal_the_ports(name):
    from benchlib import program

    cfg = small_config(name)
    trainer = program.build(cfg, TRAFFIC, 9, "cpu")
    prog = {"losses": []}
    for step in range(2):
        program.run_steps(trainer, 1)
        prog["losses"].append(trainer.history[-1]["loss"])
        if step == 0:
            prog["first"] = program.first_reading(trainer)
    prog["change"] = program.change_reading(trainer, cfg, 9)
    ref = ref_mavg.readings(cfg, TRAFFIC, 9, 2, "cpu")
    values = compare.numbers(prog, ref)
    for key in compare.NUMBERS:
        assert values[key] < 1e-4, (key, values[key])
    gp = inputs.make_params(cfg, 9, "cpu")
    v = ref_mavg.tree_map(torch.zeros_like, gp)
    for step in range(2):
        ref_mavg.meta_step(gp, v, inputs.make_batches(cfg, TRAFFIC, 9, step,
                                                      "cpu"), cfg, TRAFFIC)
    port, ref_tree = flat(program.global_tree(trainer)), flat(gp)
    assert set(port) == set(ref_tree)
    for path, x in ref_tree.items():
        torch.testing.assert_close(port[path], x, rtol=1e-4, atol=1e-6)


def flat(tree, prefix=""):
    out = {}
    for key, node in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(flat(node, path) if isinstance(node, dict)
                   else {path: node})
    return out


def test_leaf_norms_split_stacks_into_layers():
    tree = {"blocks": {"w": torch.ones(3, 2, 2)}, "embed": torch.ones(4)}
    norms = compare.leaf_norms(tree)
    assert set(norms) == {"blocks/w[0]", "blocks/w[1]", "blocks/w[2]",
                          "embed"}
    assert norms["blocks/w[1]"] == 2.0 and norms["embed"] == 2.0


def test_gaps_are_relative_to_the_leaf_or_the_median_leaf():
    ref = {"losses": [2.0], "first": {"a": 1.0, "b": 2.0, "c": 4.0,
                                      "d": 1e-9},
           "change": {"a": 1.0, "b": 2.0, "c": 4.0, "d": 5.0}}
    prog = {"losses": [2.2], "first": {"a": 1.0, "b": 2.0, "c": 4.0,
                                       "d": 0.5},
            "change": {"a": 1.5, "b": 2.0, "c": 4.0, "d": 9.0}}
    values = compare.numbers(prog, ref)
    assert math.isclose(values["loss_gap"], 0.1)
    # d's gradient is nought to rounding: its change is not compared, and
    # its gradient gap is measured against the median leaf's norm
    assert math.isclose(values["first_gap"], 0.5 / 1.5, rel_tol=1e-6)
    assert math.isclose(values["change_gap"], 0.5 / 2.0)
    assert compare.verdict(values, {"loss_gap": 0.11, "first_gap": 0.4,
                                    "change_gap": 0.25})
    assert not compare.verdict(dict(values, loss_gap=math.nan),
                               {"loss_gap": 1, "first_gap": 1,
                                "change_gap": 1})
