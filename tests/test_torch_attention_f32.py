"""The numerics of the f32 Hopper flash kernel
(``csrc/attention_hopper_f32.cu``) on the CPU, and the host-side logic
around it.

The kernel multiplies on the TF32 tensor cores: every f32 operand x is
split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and each matmul
(Q K^T, and P V with p split the same way) takes the three products
hi hi + hi lo + lo hi. ``_emulated`` repeats that arithmetic with PyTorch
(the rounding by bit operations on int32 views of the f32 words, the
products accumulated in f64), and is held to the port's f32 flash limit,
|d| <= 1e-5 + 1e-4 |ref|, against ``flash_attention_plain`` and against the
JAX package's Pallas kernel in interpret mode on the same seeded numpy
inputs. One TF32 product per matmul, what a single ``wgmma`` would give,
is not within that limit: that is why the kernel splits.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

torch.set_num_threads(2)
# ATen's CPU exp sets up its vector path at its first call; in this build a
# first call split over two threads can race and return values off by up to
# 1e-4. One call on one thread here makes every later one exact.
torch.exp(torch.zeros(8))


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: x kept to 10 explicit mantissa bits, rounded
    to nearest with ties away from zero (half an ulp of TF32 added to the
    magnitude's bits, then the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


ALL = (0, 1, 2)  # the terms hi hi, hi lo, lo hi


def _matmul(a, b, terms):
    """a @ b as the kernel's tensor-core products take it, in f64: the sum
    of the ``terms`` of (a_hi b_hi, a_hi b_lo, a_lo b_hi)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    pairs = ((ah, bh), (ah, bl), (al, bh))
    return sum(torch.matmul(pairs[t][0].double(), pairs[t][1].double())
               for t in terms)


def _emulated(q, k, v, *, qk=ALL, pv=ALL, causal=True, sliding_window=0,
              prefix_global=0):
    """The kernel's function with its products emulated (``qk`` and ``pv``
    the terms each matmul takes): q (B H, S, D), k and v (B KV, S, D).
    s = (Q K^T) rounded to f32, times the scale in f32, masked to -1e30;
    p = exp(s - max) in f32; out = (P V) / l in f64, rounded to f32 once."""
    BH, Sq, D = q.shape
    BKV, Sk, _ = k.shape
    q4 = q.view(BKV, BH // BKV, Sq, D)
    s = _matmul(q4, k[:, None].transpose(-1, -2), qk).float()
    s = s * (1.0 / math.sqrt(D))
    mask = fa.visible(torch.arange(Sq), torch.arange(Sk), causal=causal,
                      sliding_window=sliding_window,
                      prefix_global=prefix_global, kv_len=Sk)
    s = s.masked_fill(~mask, fa.NEG_INF)
    p = (s - s.amax(-1, keepdim=True)).exp()
    acc = _matmul(p, v[:, None], pv)
    return (acc / p.double().sum(-1, keepdim=True)).float().view(BH, Sq, D)


def _beyond(got, ref):
    """The share of values beyond the f32 flash limit of ``ref``."""
    d = (got.double() - ref.double()).abs()
    return float((d > 1e-5 + 1e-4 * ref.double().abs()).double().mean())


def _inputs(seed, S, D):
    """B H = 4 query rows of 2 kv rows (n_rep 2), unit normal, as the
    card's checks draw them."""
    rng = np.random.RandomState(seed)
    return (rng.randn(4, S, D).astype(np.float32),
            rng.randn(2, S, D).astype(np.float32),
            rng.randn(2, S, D).astype(np.float32))


def test_tf32_rna_rounds_to_nearest_ties_away():
    """The emulated cvt.rna on values around the TF32 grid of 1 (ulp
    2^-10), either sign; hi + lo of the split carries 21 bits or more."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      1 + ulp / 2 + 2 ** -23, 1 + 1.5 * ulp,
                      -(1 + ulp / 2), -(1 + ulp / 4)], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, 1 + 2 * ulp,
                         -(1 + ulp), -1.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    x = torch.from_numpy(np.random.RandomState(9).randn(10000)
                         .astype(np.float32))
    assert not (tf32_rna(x).view(torch.int32) & 0x1FFF).any()
    hi, lo = _split(x)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -21


CASES = [  # (seed, S, D, mask)
    (0, 512, 64, dict(causal=True)),
    (1, 512, 128, dict(causal=True)),
    (2, 256, 64, dict(causal=True, sliding_window=64, prefix_global=8)),
    (3, 256, 128, dict(causal=True, sliding_window=48, prefix_global=4)),
]


@pytest.mark.parametrize("seed,S,D,kw", CASES)
def test_3xtf32_is_within_the_f32_limit_and_1xtf32_is_not(seed, S, D, kw):
    """Three TF32 products per matmul keep every output within the f32
    limit of the plain version and of the Pallas kernel (interpret mode),
    at 3-6 % of the limit at worst; one product per matmul puts 65-73 % of
    the outputs beyond it in these cases (asserted: half)."""
    qn, kn, vn = _inputs(seed, S, D)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    plain = fa.flash_attention_plain(q, k, v, **kw)
    pallas = torch.from_numpy(np.asarray(jfa.flash_attention_bhsd(
        qn, kn, vn, interpret=True, **kw)))
    three = _emulated(q, k, v, **kw)
    one = _emulated(q, k, v, qk=(0,), pv=(0,), **kw)
    assert _beyond(three, plain) == 0.0
    assert _beyond(three, pallas) == 0.0
    assert _beyond(one, plain) >= 0.5
    assert _beyond(one, pallas) >= 0.5


@pytest.mark.parametrize("drop", ["qk_hi_lo", "qk_lo_hi", "pv_hi_lo",
                                  "pv_lo_hi"])
def test_each_of_the_three_terms_is_needed(drop):
    """Dropping hi lo or lo hi from either matmul (Q K^T's K_lo or Q_lo
    term, P V's V_lo or p_lo term) puts 40-49 % of the values beyond the
    limit of the plain version (asserted: a quarter): the kernel keeps all
    three terms of both."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 256, 64))
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    matmul, term = drop.split("_", 1)
    kept = tuple(t for t in ALL if t != {"hi_lo": 1, "lo_hi": 2}[term])
    got = _emulated(q, k, v, **{matmul: kept})
    assert _beyond(got, plain) >= 0.25


def test_tma_strides_take_f32_in_multiples_of_4():
    """The f32 operands' layout check: 16 bytes are 4 f32, so a stride of
    4 passes where bf16 needs 8; the every-other-head view of the cuda
    tests passes; a stride of 2 elements and an 8-byte base are refused."""
    q = torch.zeros(2, 80, 8, 64)
    assert fa.tma_strides("q", q) == list(q.stride()[:3])
    assert fa.tma_strides("q", q[:, :, ::2]) == [80 * 512, 512, 128]
    four = torch.zeros(2, 16, 4, 68)[..., :64]
    assert fa.tma_strides("k", four) == [16 * 4 * 68, 4 * 68, 68]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.tma_strides("k", torch.zeros(2, 16, 4, 68,
                                        dtype=torch.bfloat16)[..., :64])
    two = torch.zeros(2, 16, 4, 66)[..., :64]
    with pytest.raises(ValueError, match="multiples of 4"):
        fa.tma_strides("k", two)
    base = torch.zeros(q.numel() + 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.tma_strides("q", base[2:2 + q.numel()].view(q.shape))


TILE_CASES = [  # (Sq, Sk, causal, window, prefix, kv_len)
    (700, 700, True, 0, 0, 700),
    (700, 700, False, 0, 0, 700),
    (700, 700, True, 100, 0, 700),
    (700, 700, True, 31, 0, 700),
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
def test_f32_kv_tile_range_covers_every_visible_key(case, D):
    """At the f32 kernel's tiles (128 queries, or 64 at D = 256, by 32
    keys) every visible key of every row of a query tile lies in the kv
    tiles it visits; where a row sees no key, every tile of [0, Sk) is
    visited."""
    Sq, Sk, causal, window, prefix, kv_len = case
    bq, bk = fa.hopper_f32_block_q(D), fa.HOPPER_F32_BLOCK_K
    assert (bq, bk) == ((64 if D == 256 else 128), 32)
    skip = fa._skip_is_exact(Sq, kv_len, window, prefix)
    mask = fa.visible(torch.arange(Sq), torch.arange(Sk), causal=causal,
                      sliding_window=window, prefix_global=prefix,
                      kv_len=kv_len)
    for q0 in range(0, Sq, bq):
        starts = fa.kv_tile_starts(
            q0, Sq=Sq, Sk=Sk, block_k=bk, causal=causal,
            sliding_window=window, prefix_global=prefix, kv_len=kv_len,
            skip=skip, block_q=bq)
        seen = torch.zeros(Sk, dtype=torch.bool)
        for k0 in starts:
            assert 0 <= k0 < Sk
            seen[k0:k0 + bk] = True
        rows = mask[q0:q0 + bq]
        assert not (rows & ~seen).any(), (q0, list(starts))
        if not skip:
            assert seen.all()
