"""The port's attention against the JAX package's, on the CPU.

* ``flash_attention_plain`` (the function the CUDA kernel computes) against
  JAX's Pallas flash kernel in interpret mode (``ops.flash_attention``, and
  ``flash_attention_bhsd`` called directly for ``kv_len``) and against the
  full-softmax oracle ``ref.flash_attention_ref``, in f32 at rtol 1e-5 /
  atol 1e-6: both sides compute one softmax in f32, in another summation
  order (one-shot here, blocked in the Pallas kernel).
* ``chunked_attention`` against JAX's at small chunks, and the three
  branches of ``attention_block_kv`` (flash, chunked, full) against JAX's
  at the same tolerance.
* The flash path has no gradient: its backward raises.
* The host-side logic of the bf16 Hopper kernel: the kv tiles a query
  tile visits cover every visible key, its TMA layout check, and the
  split-p PV product emulated on the CPU (within the one-ulp limit,
  where one bf16 p is not).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402

torch.set_num_threads(2)
# ATen's CPU exp sets up its vector path at its first call; in this build a
# first call split over two threads can race and return values off by up to
# 1e-4. One call on one thread here makes every later one exact.
torch.exp(torch.zeros(8))

RTOL, ATOL = 1e-5, 1e-6

# (B, S, H, KV, D): the JAX kernel tests' cases (tests/test_kernels.py)
FA_CASES = [
    (2, 128, 4, 2, 64),
    (1, 256, 8, 8, 128),
    (2, 64, 4, 1, 80),
    (1, 96, 5, 5, 64),
    (1, 128, 4, 4, 256),
]


def _qkv(seed, B, S, H, KV, D, scale=0.3):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, H, D) * scale).astype(np.float32)
    k = (rng.randn(B, S, KV, D) * scale).astype(np.float32)
    v = (rng.randn(B, S, KV, D) * scale).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    return ops.flash_attention(*t, **kw).numpy()


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_ref(case, causal):
    q, k, v = _qkv(0, *case)
    got = _port(q, k, v, causal=causal)
    oracle = np.asarray(jref.flash_attention_ref(q, k, v, causal=causal))
    pallas = np.asarray(jops.flash_attention(q, k, v, causal=causal,
                                             interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,prefix", [(32, 0), (32, 8), (16, 4)])
def test_flash_plain_window_prefix(window, prefix):
    q, k, v = _qkv(1, 2, 128, 4, 2, 64)
    kw = dict(causal=True, sliding_window=window, prefix_global=prefix)
    got = _port(q, k, v, **kw)
    oracle = np.asarray(jref.flash_attention_ref(q, k, v, **kw))
    pallas = np.asarray(jops.flash_attention(q, k, v, interpret=True, **kw))
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_len", [0, 17, 40, 64])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_plain_kv_len_matches_pallas(kv_len, window):
    """kv_len < Sk masks the padded keys; at kv_len 0 no key is visible and
    every row is the plain mean of all Sk rows of V, as in the Pallas
    kernel (its masked score is the finite -1e30)."""
    rng = np.random.RandomState(2)
    q = rng.randn(4, 64, 64).astype(np.float32)  # (B H, S, D), n_rep 2
    k = rng.randn(2, 64, 64).astype(np.float32)
    v = rng.randn(2, 64, 64).astype(np.float32)
    kw = dict(causal=True, sliding_window=window, kv_len=kv_len)
    pallas = np.asarray(jfa.flash_attention_bhsd(
        q, k, v, block_q=32, block_k=32, interpret=True, **kw))
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   **kw).numpy()
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    if kv_len == 0:
        mean_v = np.repeat(v.mean(axis=1, keepdims=True), 64, axis=1)
        np.testing.assert_allclose(got, np.repeat(mean_v, 2, axis=0),
                                   rtol=RTOL, atol=ATOL)


def test_flash_plain_query_offset_is_a_window_of_the_whole():
    """``q_offset`` (the card's windowed comparison) gives the rows of the
    whole call, in every mask."""
    q, k, v = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
               for x in _qkv(3, 1, 96, 4, 2, 64))
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, sliding_window=16, prefix_global=4)):
        whole = fa.flash_attention_plain(q, k, v, **kw)
        part = fa.flash_attention_plain(q[:, 40:72], k, v, q_offset=40,
                                        **kw)
        torch.testing.assert_close(part, whole[:, 40:72], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("S,qc,kc", [(96, 32, 16), (256, 64, 128)])
@pytest.mark.parametrize("window,prefix", [(0, 0), (24, 0), (24, 4)])
def test_chunked_attention_matches_jax(S, qc, kc, window, prefix):
    q, k, v = _qkv(4, 2, S, 4, 2, 32, scale=1.0)
    kw = dict(causal=True, sliding_window=window, q_chunk=qc, kv_chunk=kc,
              prefix_global=prefix)
    want = np.asarray(jlayers.chunked_attention(q, k, v, **kw))
    got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                   **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = np.asarray(jlayers.full_attention(
        q, k, v, causal=True, sliding_window=window, prefix_global=prefix))
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("branch", ["flash", "chunked", "full"])
def test_attention_block_kv_branches_match_jax(branch, monkeypatch):
    """``attention_block_kv`` on reduced Qwen3 weights: the flash kernel
    (use_pallas), the blockwise path above the chunk threshold (lowered to
    32 in both packages for the test), and the plain path."""
    cfg_j = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                                dtype="float32")
    cfg_t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                dtype="float32")
    if branch == "chunked":
        monkeypatch.setattr(jlayers, "ATTN_CHUNK_THRESHOLD", 32)
        monkeypatch.setattr(layers, "ATTN_CHUNK_THRESHOLD", 32)
    p = jax.device_get(jlayers.init_attention(jax.random.PRNGKey(5), cfg_j))
    x = (np.random.RandomState(6).randn(2, 64, cfg_j.d_model) * 0.5).astype(
        np.float32)
    pos = np.arange(64)
    use_pallas = branch == "flash"
    want = jax.jit(lambda p, x: jlayers.attention_block_kv(
        x, p, cfg_j, jnp.asarray(pos), use_pallas))(p, x)
    got = layers.attention_block_kv(
        torch.from_numpy(x), interop.params_from_jax(p), cfg_t,
        torch.from_numpy(pos), use_pallas)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_has_no_backward():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(7, 1, 32, 4, 2, 64))
    out = ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="Queue 2, item 4"):
        out.sum().backward()


def test_flash_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 16, 2, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bshd_cuda(q, k, v)
    assert fa.LAUNCHES == 0


def test_skip_rule_holds_only_where_every_row_sees_a_key():
    """The kernel skips fully masked kv tiles only where each row sees a
    key; checked here against the plain mask."""
    for Sq, kv_len, window, prefix in [(64, 64, 0, 0), (64, 0, 0, 0),
                                       (64, 64, 16, 0), (64, 10, 16, 0),
                                       (64, 49, 16, 0), (64, 10, 16, 2),
                                       (1, 1, 1, 0)]:
        mask = fa.visible(torch.arange(Sq), torch.arange(64), causal=True,
                          sliding_window=window, prefix_global=prefix,
                          kv_len=kv_len)
        assert fa._skip_is_exact(Sq, kv_len, window, prefix) == bool(
            mask.any(dim=1).all()), (Sq, kv_len, window, prefix)
    assert math.isclose(fa.NEG_INF, jfa.NEG_INF)


# ---------------------------------------------------------------------------
# host-side logic of the Hopper (bf16) kernel
# ---------------------------------------------------------------------------

TILE_CASES = [  # (Sq, Sk, causal, window, prefix, kv_len)
    (700, 700, True, 0, 0, 700),
    (700, 700, False, 0, 0, 700),
    (700, 700, True, 100, 0, 700),
    (700, 700, True, 300, 0, 700),
    (700, 700, True, 100, 8, 700),
    (700, 700, True, 0, 0, 77),
    (700, 700, True, 0, 0, 0),
    (700, 700, True, 64, 0, 1),
    (300, 700, True, 0, 0, 700),
    (300, 700, False, 50, 0, 500),
    (1, 1, True, 0, 0, 1),
    (129, 40, True, 16, 0, 40),
]


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("D", [128, 256])
def test_kv_tile_range_covers_every_visible_key(case, D):
    """Every visible key of every row of a 128-query tile lies in the kv
    tiles the kernel visits at its BK (128, or 64 at D = 256); where a row
    sees no key, every tile of [0, Sk) is visited, so that the row keeps
    the mean of V."""
    Sq, Sk, causal, window, prefix, kv_len = case
    bk = fa.hopper_block_k(D)
    assert bk == (64 if D == 256 else 128)
    skip = fa._skip_is_exact(Sq, kv_len, window, prefix)
    mask = fa.visible(torch.arange(Sq), torch.arange(Sk), causal=causal,
                      sliding_window=window, prefix_global=prefix,
                      kv_len=kv_len)
    for q0 in range(0, Sq, fa.HOPPER_BLOCK_Q):
        starts = fa.kv_tile_starts(
            q0, Sq=Sq, Sk=Sk, block_k=bk, causal=causal,
            sliding_window=window, prefix_global=prefix, kv_len=kv_len,
            skip=skip)
        seen = torch.zeros(Sk, dtype=torch.bool)
        for k0 in starts:
            assert 0 <= k0 < Sk
            seen[k0:k0 + bk] = True
        rows = mask[q0:q0 + fa.HOPPER_BLOCK_Q]
        assert not (rows & ~seen).any(), (q0, list(starts))
        if not skip:
            assert seen.all()


def test_tma_strides_refuse_what_the_tensor_maps_cannot_take():
    """The Hopper wrapper's layout check: a 16-byte aligned base and
    strides that are multiples of 8 elements; the strided every-other-head
    view of the cuda tests passes with its own strides; a dim of length 1
    gets the stride of a contiguous layout."""
    base = torch.zeros(2 * 80 * 8 * 64 + 8, dtype=torch.bfloat16)
    q = base[:2 * 80 * 8 * 64].view(2, 80, 8, 64)
    assert fa.tma_strides("q", q) == list(q.stride()[:3])
    view = q[:, :, ::2]
    assert fa.tma_strides("q", view) == [80 * 512, 512, 128]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.tma_strides("q", base[1:1 + q.numel()].view(q.shape))
    wide = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.tma_strides("k", wide)
    one = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 64), (3, 5, 7, 1))
    assert fa.tma_strides("v", one) == [64, 64, 64]


def _within_flash_limit(got, plain32):
    """The bf16 limit of the kernels against the plain f32 result: one bf16
    ulp of it, or 1e-5 + 1e-4 |p| where that is wider. The share of values
    beyond it."""
    p = plain32.to(torch.float64)
    _, e = torch.frexp(plain32)
    ulp = torch.where(plain32 == 0, torch.zeros_like(plain32),
                      torch.ldexp(torch.ones_like(plain32), e - 8))
    limit = torch.maximum(1e-5 + 1e-4 * p.abs(), ulp.to(torch.float64))
    return float(((got.to(torch.float64) - p).abs() > limit)
                 .to(torch.float64).mean())


def _pv_emulated(q, k, v, split):
    """The Hopper kernel's PV product on the CPU: p in f32 as the plain
    version makes it, the row sum l of the f32 p, the products of p's bf16
    parts (p_hi = bf16(p), p_lo = bf16(p - p_hi); p_hi alone without
    ``split``) with V taken in f64, the result divided by l and rounded to
    bf16 once."""
    Sq, D = q.shape[-2:]
    s = torch.matmul(q, k.transpose(-1, -2)).mul_(1.0 / math.sqrt(D))
    mask = fa.visible(torch.arange(Sq), torch.arange(k.shape[-2]),
                      causal=True, sliding_window=0, prefix_global=0,
                      kv_len=k.shape[-2])
    s.masked_fill_(~mask, fa.NEG_INF)
    p = (s - s.amax(-1, keepdim=True)).exp()
    hi = p.to(torch.bfloat16).to(torch.float32)
    parts = [hi, (p - hi).to(torch.bfloat16).to(torch.float32)]
    acc = sum(torch.matmul(x.double(), v.double())
              for x in (parts if split else parts[:1]))
    return (acc / p.double().sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_pv_split_keeps_the_one_ulp_limit(seed):
    """p split into two bf16 parts keeps every output within the flash
    limit of the plain f32 result on seeded bf16 inputs (B H = 4, S = 512,
    D = 64, causal); one bf16 p, what a single bf16 wgmma operand would
    give, does not (about 17 % of values beyond it here)."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(4, 512, 64).astype(np.float32))
               .to(torch.bfloat16).to(torch.float32) for _ in range(3))
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert _within_flash_limit(_pv_emulated(q, k, v, True), want) == 0.0
    assert _within_flash_limit(_pv_emulated(q, k, v, False), want) > 0.05
