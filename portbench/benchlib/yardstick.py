"""The yardstick: the chip's peaks, the model FLOPs of a token and the
bytes of a kernel call. Imports only the standard library.

* ``H100_SXM``: a frozen copy of ``src/repro_torch/roofline/terms.py::
  H100_SXM`` at commit a2698f40, the H100 SXM data sheet's dense rates
  (no sparsity), which assume the card's full 700 W power limit.
* ``model_flops_per_token``: the model FLOPs a trained token costs,
  forward + backward = 3 x forward, where forward is 2 x the matmul
  parameters a token uses (attention projections; the dense FFN, or the
  router, the shared experts and the top-k routed experts; the output
  head) + the causal score and value products, 4 x (S / 2) x heads x
  head_dim a layer. Recomputation and expert capacity padding are not
  counted: they are work the program chose, not work the model needs.
* ``sgd_apply_bytes`` and ``fused_momentum_broadcast_bytes``: frozen
  copies of the declared costs in ``src/repro_torch/kernels/
  {local_sgd,fused_meta}.py`` (``cost``) at commit a2698f40, which count
  each input read once and each output written once.
"""
from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,
    "tf32_flops_per_s": 494.7e12,
    "bf16_flops_per_s": 989.4e12,
}


def attention_matmul_params(cfg: dict) -> int:
    d, nq, nkv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                      cfg["head_dim"])
    return 2 * d * nq * hd + 2 * d * nkv * hd


def ffn_matmul_params(d: int, f: int) -> int:
    """SwiGLU: gate and up (d -> 2f), down (f -> d)."""
    return 3 * d * f


def active_matmul_params(cfg: dict) -> int:
    """Matmul parameters one token uses in a forward pass."""
    d = cfg["d_model"]
    n = cfg["num_layers"]
    attn = attention_matmul_params(cfg)
    if cfg.get("num_experts"):
        nd = cfg.get("first_dense_layers", 0)
        de = cfg["d_expert"]
        moe = (d * cfg["num_experts"]
               + ffn_matmul_params(d, cfg.get("num_shared_experts", 0) * de)
               + cfg["moe_top_k"] * ffn_matmul_params(d, de))
        layers = nd * (attn + ffn_matmul_params(d, cfg["d_ff"])) \
            + (n - nd) * (attn + moe)
    else:
        layers = n * (attn + ffn_matmul_params(d, cfg["d_ff"]))
    return layers + d * cfg["vocab_size"]


def attention_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward flops of the causal score and value products a token."""
    return (cfg["num_layers"] * 4 * (seq_len / 2) * cfg["num_heads"]
            * cfg["head_dim"])


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    forward = 2 * active_matmul_params(cfg) \
        + attention_flops_per_token(cfg, seq_len)
    return 3 * forward


def sgd_apply_bytes(plane_bytes: int) -> int:
    """w and g read, w written."""
    return 3 * plane_bytes


def fused_momentum_broadcast_bytes(plane_bytes: int, learners: int,
                                   learner_itemsize: int = 4) -> int:
    """w, v and the mean read; w', v' and the L learner planes written."""
    return 5 * plane_bytes + learners * plane_bytes // 4 * learner_itemsize
