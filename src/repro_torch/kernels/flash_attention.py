"""Flash attention: blocked online-softmax attention with GQA and the
causal, sliding-window, prefix-global and kv-length masks.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
``flash_attention_bhsd``. It is reached through the model's ``use_pallas``
forward and the prefill of the serving path (``models/layers.py``
``attention_block_kv``), once per layer, through ``ops.flash_attention``.

The function, in the kernel and in ``flash_attention_plain`` alike: q, k and
v upcast to f32; s = (q k^T) * scale; a masked score is the finite -1e30 (so
a row that no key can see ends as the plain mean of all Sk rows of V, as in
the Pallas kernel); softmax and the PV product in f32; the result divided by
max(l, 1e-30) and cast once to q's dtype. Query row ``bh`` reads kv row
``bh // n_rep``; K and V are never repeated in memory. In f32 this is
``flash_attention_ref``'s formula; at bf16 it differs from the plain
``full_attention``, which casts the probabilities to bf16 before the PV
product (by design, in both packages).

Bound by bytes at the serving prefill (B=8, S=512) and by operations from
S of a few thousand on: 4 B H Sq Sk D flops (times the visible share of
the (Sq, Sk) square) against (q + k + v + o) bytes. The CUDA route splits
by dtype, one Hopper kernel each, and there is no fallback between them:

* bfloat16 goes to ``csrc/attention_hopper.cu``
  (``repro_flash_attention_hopper``): one CTA of three warpgroups per (b h,
  tile of 128 queries), TMA loads of Q once and of K/V tiles of
  ``hopper_block_k(D)`` keys into a 2-stage ring, ``wgmma`` on the tensor
  cores for QK^T and for PV, with p split into two bf16 parts so that the
  PV product keeps p to about 16 bits (the f32 p of the reference).
* float32 goes to ``csrc/attention_hopper_f32.cu``
  (``repro_flash_attention_hopper_f32``), on the tensor cores too: the
  TF32 ``wgmma`` multiplies 11-bit mantissas, so every f32 operand is split
  into two TF32 parts, x = hi + lo, and each matmul takes three products,
  hi hi + hi lo + lo hi ("3xTF32"), which keeps a product to about 21 bits
  and the result within the f32 limit of the plain version (one TF32
  product does not). One CTA per (b h, tile of ``hopper_f32_block_q(D)``
  queries), K/V tiles of ``HOPPER_F32_BLOCK_K`` keys; a producer
  warpgroup loads them by TMA and converts them (hi and lo of K, and V
  transposed, since a 32-bit ``wgmma`` operand must be K-major).

TMA reads the operands through tensor maps over their (batch, seq, head)
strides, so a base must be 16-byte aligned and a stride a multiple of 16
bytes, 8 bf16 or 4 f32 elements (``tma_strides`` checks and raises
``ValueError``). Both kernels read the (B, S, H, D) projections as they
are (no transpose copy), take any Sq and Sk, and skip kv tiles that are
masked for every row of a block only where that leaves the result
unchanged (``kv_tile_starts``). Both are compiled for the head dims of the
repo's configs, 64, 80, 112, 128 and 256, and refuse any other. CPU
tensors take the plain version; ``chip_smoke.py`` holds the kernels to it
on the card.

There is no gradient: the Pallas kernel has no VJP and no trainer sets
``use_pallas``. Both routes run inside ``FlashAttentionFn``, whose backward
raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.planes import KERNEL_DTYPES

NEG_INF = -1e30  # the masked score (finite, as the Pallas kernel's)
HEAD_DIMS = (64, 80, 112, 128, 256)  # the configs' head dims, compiled

HOPPER_BLOCK_Q = 128  # query rows of a CTA of the Hopper kernel
HOPPER_F32_BLOCK_K = 32  # keys of a K/V tile of the f32 Hopper kernel

# kernel launches by ``flash_attention_bshd_cuda``: the bf16 kernel adds
# one to LAUNCHES, the f32 kernel to F32_LAUNCHES
LAUNCHES = 0
F32_LAUNCHES = 0


class FlashAttentionFn(torch.autograd.Function):
    """Runs ``fn(*tensors)`` with no backward: the TPU kernel has none, and
    the plain version is never substituted for one."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention has no backward (ROADMAP Queue 2, item 4: a "
            "Hopper backward kernel comes when training uses it); train "
            "with use_pallas=False")


def visible(qpos, kpos, *, causal, sliding_window, prefix_global, kv_len):
    """The (Sq, Sk) mask of the Pallas kernel: ``kpos < kv_len``, causal
    ``qpos >= kpos``, window ``qpos - kpos < window`` OR-ed with ``kpos <
    prefix`` when a prefix is set."""
    qp, kp = qpos[:, None], kpos[None, :]
    mask = kp < kv_len
    if causal:
        mask = mask & (qp >= kp)
    if sliding_window:
        win = qp - kp < sliding_window
        if prefix_global:
            win = win | (kp < prefix_global)
        mask = mask & win
    return mask


def flash_attention_plain(q, k, v, *, causal=True, sliding_window=0,
                          prefix_global=0, kv_len=None, scale=None,
                          q_offset=0):
    """q (BH, Sq, D); k, v (BKV, Sk, D), BH = BKV n_rep -> (BH, Sq, D) in
    q's dtype. ``q_offset`` places the queries at absolute positions
    ``q_offset + i`` (to compare a window of queries at a time)."""
    BH, Sq, D = q.shape
    BKV, Sk, _ = k.shape
    if BH % BKV:
        raise ValueError(f"{BH} query rows for {BKV} kv rows")
    n_rep = BH // BKV
    kv_len = Sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q32 = q.to(torch.float32).view(BKV, n_rep, Sq, D)
    k32 = k.to(torch.float32)[:, None]
    v32 = v.to(torch.float32)[:, None]
    s = torch.matmul(q32, k32.transpose(-1, -2)).mul_(scale)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = visible(qpos, kpos, causal=causal, sliding_window=sliding_window,
                   prefix_global=prefix_global, kv_len=kv_len)
    s.masked_fill_(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v32).div_(l.clamp_(min=1e-30))
    return out.view(BH, Sq, D).to(q.dtype)


def flash_attention_bshd_plain(q, k, v, *, causal=True, sliding_window=0,
                               prefix_global=0, scale=None):
    """The plain version on (B, S, H, D) / (B, S, KV, D) projections, as
    the JAX wrapper ``kernels/ops.py::flash_attention`` lays them out for
    the kernel: (B H, S, D) copies, then back."""
    B, S, H, D = q.shape
    KV = k.shape[2]

    def prep(x, nh):
        return x.transpose(1, 2).reshape(B * nh, x.shape[1], D)

    out = flash_attention_plain(
        prep(q, H), prep(k, KV), prep(v, KV), causal=causal,
        sliding_window=sliding_window, prefix_global=prefix_global,
        scale=scale)
    return out.view(B, H, S, D).transpose(1, 2).contiguous()


def _check(name, x, dtype, device):
    if x.device.type != "cuda" or x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: expected a float32 or bfloat16 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                         f"{dtype} on {device} (q's)")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")


def _skip_is_exact(Sq, kv_len, sliding_window, prefix_global) -> bool:
    """Whether every query row sees at least one key. Then a kv tile that
    is masked for every row of a block adds exactly 0 once a visible tile
    has set the row's max, and wipes out (alpha = 0) what it added before
    it, so the kernel may skip it. A row that no key sees keeps the mean of
    all Sk rows of V instead, and every tile must then be visited."""
    if kv_len < 1:
        return False
    if not sliding_window or prefix_global:
        return True  # key 0 is visible to every row
    # the last row's nearest allowed key is min(qpos, kv_len - 1)
    return Sq - 1 < kv_len - 1 + sliding_window


def hopper_block_k(D: int) -> int:
    """Keys per K/V tile of the Hopper kernel: 128, or 64 at D = 256 so
    that the output accumulator (D / 2 f32 a thread) stays in registers."""
    return 64 if D > 128 else 128


def hopper_f32_block_q(D: int) -> int:
    """Query rows of a CTA of the f32 Hopper kernel: 128 (two consumer
    warpgroups), or 64 at D = 256, whose shared memory holds one."""
    return 64 if D > 128 else 128


def kv_tile_starts(q0, *, Sq, Sk, block_k, causal, sliding_window,
                   prefix_global, kv_len, skip, block_q=HOPPER_BLOCK_Q):
    """The first key of each kv tile that the query tile ``[q0, q0 +
    block_q)`` visits, as the kernels compute it: every tile of [0, Sk)
    unless ``skip`` (``_skip_is_exact``); then only keys below the tile's
    last row (causal), below kv_len, and from its first row's window start
    on (a window without a prefix)."""
    k_lo, k_hi = 0, Sk
    if skip:
        q_last = min(q0 + block_q, Sq) - 1
        if causal:
            k_hi = min(k_hi, q_last + 1)
        k_hi = min(k_hi, kv_len)
        if sliding_window > 0 and prefix_global == 0:
            k_lo = max(0, q0 - sliding_window + 1)
    return range(k_lo, k_hi, block_k)


def tma_strides(name, x):
    """The (batch, seq, head) strides of an operand of the Hopper kernels,
    as their tensor maps take them: raises ``ValueError`` unless the base
    is 16-byte aligned and every stride of a dim longer than 1 a multiple
    of 16 bytes (8 bf16 or 4 f32 elements). A dim of length 1 gets the
    stride a contiguous layout would give it, since its own is never
    used."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the base address {x.data_ptr():#x} is "
                         f"not 16-byte aligned (the Hopper kernels read "
                         f"through TMA)")
    unit = 16 // x.element_size()
    sizes, strides = x.shape[:3], list(x.stride()[:3])
    bad = [st for n, st in zip(sizes, strides) if n > 1 and st % unit]
    if bad:
        raise ValueError(f"{name}: strides {tuple(strides)} are not "
                         f"multiples of {unit} elements (the Hopper kernels "
                         f"read through TMA)")
    # in the tensor map's order (head, seq, batch), each from the one inside
    inner = x.shape[3]
    for dim in (2, 1, 0):
        if sizes[dim] == 1:
            strides[dim] = inner
        inner = strides[dim] * sizes[dim]
    return strides


def flash_attention_bshd_cuda(q, k, v, *, causal=True, sliding_window=0,
                              prefix_global=0, kv_len=None, scale=None):
    """The kernel on (B, Sq, H, D) q and (B, Sk, KV, D) k, v CUDA tensors,
    any strides with a contiguous head dim (the model's projections are
    read as they are; ``tma_strides`` checks them), D one of ``HEAD_DIMS``
    -> a new contiguous (B, Sq, H, D) tensor in q's dtype. bfloat16
    launches the bf16 Hopper kernel, float32 the 3xTF32 one."""
    global LAUNCHES, F32_LAUNCHES
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is compiled for "
                         f"{HEAD_DIMS}")
    if H % KV or tuple(k.shape) != (B, Sk, KV, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, Sq, H, D) and "
                         f"(B, Sk, KV, D) with KV dividing H")
    if Sq < 1 or Sk < 1 or B < 1:
        raise ValueError(f"empty attention: B={B}, Sq={Sq}, Sk={Sk}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.dtype, q.device)
    strides = [s for name, x in (("q", q), ("k", k), ("v", v))
               for s in tma_strides(name, x)]
    kv_len = Sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    lib = build.library()
    with torch.cuda.device(q.device):
        lib.call(
            "repro_flash_attention_hopper" if bf16
            else "repro_flash_attention_hopper_f32", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, D,
            *strides, *out.stride()[:3], int(causal), int(sliding_window),
            int(prefix_global), int(kv_len),
            int(_skip_is_exact(Sq, kv_len, sliding_window, prefix_global)),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if bf16:
        LAUNCHES += 1
    else:
        F32_LAUNCHES += 1
    return out
