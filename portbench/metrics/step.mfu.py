"""Model FLOPs of the window's tokens over the window's seconds and the
H100 SXM dense BF16 peak, in % (``benchlib/yardstick.py``: 3 x the
forward's matmul and causal attention FLOPs a token, no recomputation, no
capacity padding). The card's power limit is printed beside it."""


def read(ctx):
    achieved = ctx.tokens * ctx.flops_per_token / ctx.window_s
    return 100.0 * achieved / ctx.peaks["bf16_flops_per_s"]
