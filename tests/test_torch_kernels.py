"""The port's meta-phase kernels against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions, on the
same numpy inputs as the JAX side:

* BITWISE against the JAX oracles of ``repro/kernels/ref.py``, run eagerly
  op by op (every product and sum rounded on its own, as in the port);
* within ``FMA_ULPS`` against the Pallas kernels in interpret mode (the way
  the JAX tests run them). XLA:CPU contracts ``mu*v + eta*d``,
  ``w + mu*v'`` and ``w - lr*g`` into fused multiply-adds inside the jitted
  kernel body, and a skipped product rounding moves an element by a few
  ulps of the operands it combines (more than 1 ulp of the result where
  they cancel), so the bound is taken at the largest operand.

The wire-compression kernels (quantize, dequantize, pack_update) follow
the same pattern: their plain versions equal the ``ref.py`` oracles
bitwise on the same dither. Against the Pallas kernels in interpret mode
the rounding decisions q are identical, but the jitted kernel bodies
divide by qmax through a reciprocal (the scale may move by one ulp) and
contract ``d - q*s`` into an FMA, so ``c`` and ``err`` agree within
``PACK_ULPS`` ulps of their chunk's max |d|.

The CUDA kernels (built with no FMA contraction) are held bitwise to the
plain versions on the card by ``chip_smoke.py`` and by the ``cuda``-marked
tests of tests/test_torch_cuda.py, which skip without a card.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack_update as jpu  # noqa: E402
from repro.kernels import quantize as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import block_momentum as bm  # noqa: E402
from repro_torch.kernels import fused_meta as fm  # noqa: E402
from repro_torch.kernels import local_sgd as sgd  # noqa: E402
from repro_torch.kernels import pack_update as pu  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402

torch.set_num_threads(2)


ROWS = 264  # a multiple of 8 that is not a multiple of the 256-row block
L = 3


def _planes(seed, n=3, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, 128)).astype(np.float32)
            for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _np(x):
    x = x.detach()
    return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()


def _jnp(x):
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


FMA_ULPS = 8


def _assert_fma_close(got, want, *operands, bf16=False):
    """|got - want| <= FMA_ULPS ulps of the largest operand, elementwise;
    a bf16 result may differ by one bf16 ulp there (the f32 value it
    rounds from moved)."""
    scale = np.maximum.reduce([np.abs(np.asarray(o, np.float32))
                               for o in operands])
    bound = (np.spacing(scale) * 2.0 ** 16 if bf16
             else FMA_ULPS * np.spacing(scale))
    diff = np.abs(_np(got) - _jnp(want))
    assert np.all(diff <= bound), float((diff / bound).max())


LDTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("mu", [0.0, 0.7])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("ldtypes", LDTYPES, ids=["f32", "bf16"])
def test_fused_momentum_broadcast_plain_bitwise(mu, nesterov, ldtypes):
    t_ld, j_ld = ldtypes
    w, v, a = _planes(1)
    eta = 0.9
    got = ops.fused_momentum_broadcast(
        *_t(w, v, a), mu=mu, eta=eta, num_learners=L, ldtype=t_ld,
        nesterov=nesterov,
    )
    want_ref = jref.fused_momentum_broadcast_ref(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(a), mu, eta, L, j_ld,
        nesterov=nesterov,
    )
    want_pl = jops.fused_momentum_broadcast(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(a), mu=mu, eta=eta,
        num_learners=L, ldtype=j_ld, nesterov=nesterov, use_pallas=True,
        interpret=True,
    )
    assert got[2].shape == (L, ROWS, 128) and got[2].dtype == t_ld
    for g, x in zip(got, want_ref):
        np.testing.assert_array_equal(_np(g), _jnp(x))
    ops_ = (w, v, a, _np(got[0]), _np(got[1]))
    _assert_fma_close(got[0], want_pl[0], *ops_)
    _assert_fma_close(got[1], want_pl[1], *ops_)
    _assert_fma_close(got[2], want_pl[2], *ops_,
                      bf16=t_ld == torch.bfloat16)


@pytest.mark.parametrize("mu", [0.0, 0.7])
@pytest.mark.parametrize("nesterov", [False, True])
def test_block_momentum_plain_bitwise(mu, nesterov):
    w, v, a = _planes(2)
    got = ops.block_momentum(*_t(w, v, a), mu=mu, eta=1.0,
                             nesterov=nesterov)
    args = [jnp.asarray(x) for x in (w, v, a)]
    want_ref = jref.block_momentum_ref(*args, mu, 1.0, nesterov=nesterov)
    want_pl = jops.block_momentum(*args, mu=mu, eta=1.0, nesterov=nesterov,
                                  interpret=True)
    for g, x, y in zip(got, want_ref, want_pl):
        np.testing.assert_array_equal(_np(g), _jnp(x))
        _assert_fma_close(g, y, w, v, a, _np(got[0]), _np(got[1]))


@pytest.mark.parametrize("ldtypes", LDTYPES, ids=["f32", "bf16"])
def test_sgd_apply_plain_bitwise(ldtypes):
    t_ld, j_ld = ldtypes
    w, g = _planes(3, n=2)
    lr = np.float32(0.037)
    tw, tg = (x.to(t_ld) for x in _t(w, g))
    got = ops.sgd_apply(tw, tg, lr)
    jw, jg = jnp.asarray(w).astype(j_ld), jnp.asarray(g).astype(j_ld)
    want_ref = jref.sgd_apply_ref(jw, jg, lr)
    want_pl = jops.sgd_apply(jw, jg, lr, interpret=True)
    assert got.dtype == t_ld
    np.testing.assert_array_equal(_np(got), _jnp(want_ref))
    _assert_fma_close(got, want_pl, _np(tw), lr * _np(tg),
                      bf16=t_ld == torch.bfloat16)


def test_in_place_outputs_match_fresh_outputs():
    """The meta step writes the kernels' outputs over their inputs."""
    w, v, a = _planes(4)
    fresh = ops.fused_momentum_broadcast(*_t(w, v, a), mu=0.7,
                                         num_learners=L)
    tw, tv, ta = _t(w, v, a)
    learners = torch.empty((L, ROWS, 128))
    out = ops.fused_momentum_broadcast(tw, tv, ta, mu=0.7, num_learners=L,
                                       w_out=tw, v_out=tv,
                                       learners_out=learners)
    assert out[0] is tw and out[1] is tv and out[2] is learners
    for g, x in zip(out, fresh):
        assert torch.equal(g, x)
    tw, tg = _t(w, v)
    want = ops.sgd_apply(tw, tg, 0.1)
    assert ops.sgd_apply(tw, tg, 0.1, out=tw) is tw and torch.equal(tw, want)


@pytest.mark.parametrize("shape", [(5,), (3, 7, 11), (130, 129)])
def test_per_leaf_layout_matches_jax_ops(shape):
    """Leaves that are not planes go through the (rows, 128) pad/reshape
    of the JAX ops.py and come back in their own shape."""
    rng = np.random.default_rng(5)
    w, v, a = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    got = ops.block_momentum(*_t(w, v, a), mu=0.5, eta=1.0)
    want = jops.block_momentum(*(jnp.asarray(x) for x in (w, v, a)),
                               mu=0.5, eta=1.0, interpret=True)
    for g, x in zip(got, want):
        assert tuple(g.shape) == shape
        _assert_fma_close(g, x, w, v, a, _np(got[0]), _np(got[1]))
    lr = np.float32(0.1)
    got = ops.sgd_apply(*_t(w, v), lr)
    want = jops.sgd_apply(jnp.asarray(w), jnp.asarray(v), lr,
                          interpret=True)
    assert tuple(got.shape) == shape
    _assert_fma_close(got, want, w, lr * v)


def test_cuda_path_has_no_fallback(monkeypatch):
    """A CUDA kernel wrapper refuses CPU tensors, an unknown device has no
    route, a meta tensor (the cost model's) launches nothing, and a
    missing nvcc is an error, not a silent plain run."""
    w, g = _t(*_planes(6, n=2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgd.sgd_apply_cuda(w, g, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.fused_momentum_broadcast_cuda(w, g, g, 0.7, 1.0, 2,
                                         torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bm.block_momentum_cuda(w, g, g, 0.7, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        qk.quantize_cuda(w, g, 127, 8)
    q = torch.zeros((ROWS, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        qk.dequantize_cuda(q, torch.ones(ROWS // 8, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pu.pack_update_cuda(w[None], g, None, w[None], 127, 8)
    other = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel"):
        ops._route(other, sgd.sgd_apply_plain, sgd.sgd_apply_cuda, sgd.cost)
    meta = torch.empty((8, 128), device="meta")
    ops.reset_launch_counts()
    assert ops.sgd_apply(meta, meta, 0.1).device.type == "meta"
    assert ops.quantize(meta, lambda shape: meta, qmax=127)[0].is_meta
    assert ops.pack_update(meta[None], meta, None, meta[None])[0].is_meta
    assert not any(ops.launch_counts().values())
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "_LIBRARY", None)
    monkeypatch.setattr(build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()


def test_launch_counter_counts_kernel_launches_only():
    ops.reset_launch_counts()
    ops.sgd_apply(*_t(*_planes(7, n=2)), 0.1)  # CPU: the plain version
    x = _t(*_planes(7, n=1))[0]
    ops.quant_dequant(x, lambda shape: torch.rand(shape))
    ops.pack_update(x[None], x, None, torch.rand(1, ROWS, 128))
    ops.pack_compress(x[None], torch.rand(1, ROWS, 128))
    ops.neighbor_mix(torch.stack([x, x]), torch.eye(2))
    ops.robust_reduce(torch.stack([x, x, x]), trim=1)
    qkv = torch.rand(1, 16, 2, 64)
    ops.flash_attention(qkv, qkv, qkv)
    assert ops.launch_counts() == {"fused_momentum_broadcast": 0,
                                   "block_momentum": 0, "sgd_apply": 0,
                                   "pack_update": 0, "quantize": 0,
                                   "dequantize": 0, "pack_compress": 0,
                                   "neighbor_mix": 0,
                                   "neighbor_mix_stepped": 0,
                                   "robust_reduce": 0,
                                   "flash_attention": 0,
                                   "flash_attention_f32": 0}


# ---------------------------------------------------------------------------
# wire compression: quantize, dequantize, fp8, pack_update
# ---------------------------------------------------------------------------

# |c - c_pallas| and |err - err_pallas| bound, in ulps of the chunk's
# max |d|: a one-ulp scale moves c = q s by up to |q| ulps of s (about 2
# ulps of the max), the rounding of c adds one, and the FMA-contracted
# d - q s one more
PACK_ULPS = 4
QROWS = 192  # 64 divides it: chunks of 64 rows, or of 8 on request


def _dither(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _chunk_ulps(x, block):
    """ulp of each chunk's max |x|, broadcast back to x's shape."""
    lead = x.shape[:-2]
    xb = np.abs(x).reshape(lead + (-1, block * 128))
    amax = xb.max(axis=-1, keepdims=True)
    return np.broadcast_to(np.spacing(amax), xb.shape).reshape(x.shape)


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("qmax", [127, 7])
def test_quantize_dequantize_plain_bitwise(block, qmax):
    x = _planes(10, n=1, rows=QROWS)[0] * np.float32(0.03)
    u = _dither(11, x.shape)
    q, s = ops.quantize(torch.from_numpy(x),
                        lambda shape: torch.from_numpy(u.copy()),
                        qmax=qmax, block=block)[:2]
    qr, sr = jref.quantize_ref(jnp.asarray(x), jnp.asarray(u), qmax, block)
    assert q.dtype == torch.int8 and tuple(s.shape) == (QROWS // block, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    np.testing.assert_array_equal(
        ops.dequantize(q, s, (QROWS, 128), QROWS * 128).numpy(),
        np.asarray(jref.dequantize_ref(qr, sr)))
    # the Pallas kernels: the same decisions q, the scale within one ulp;
    # dequantize of the same (q, s) is one product, so bitwise
    qp, sp = jq.quantize_2d(jnp.asarray(x), jnp.asarray(u), qmax=qmax,
                            block=block, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    assert np.all(np.abs(s.numpy() - np.asarray(sp))
                  <= np.spacing(np.asarray(sp)))
    np.testing.assert_array_equal(
        qk.dequantize_plain(q, s).numpy(),
        np.asarray(jq.dequantize_2d(jnp.asarray(q.numpy()),
                                    jnp.asarray(s.numpy()),
                                    interpret=True)))


@pytest.mark.parametrize("block", [8, 64])
def test_fp8_roundtrip_plain_bitwise(block):
    x = _planes(12, n=1, rows=QROWS)[0]
    x[:block] = 0.0  # an all-zero chunk keeps its zeros
    got = qk.fp8_roundtrip_plain(torch.from_numpy(x), block)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.fp8_roundtrip_ref(jnp.asarray(x),
                                                       block)))
    assert not got[:block].any()


@pytest.mark.parametrize("shape", [(5,), (3, 7, 11), (2, 130, 129)])
@pytest.mark.parametrize("dtype", ["int8", "int4", "fp8"])
def test_quant_dequant_layout_matches_jax_ops(shape, dtype):
    """Leaves of any shape go through the (rows, 128) wire layout of the
    JAX ops.py and come back in their own shape, on JAX's own dither."""
    x = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def dither(shp):
        return torch.from_numpy(np.array(jax.random.uniform(key, shp)))

    got, nchunks = ops.quant_dequant(torch.from_numpy(x), dither,
                                     dtype=dtype)
    want, jchunks = jops.quant_dequant(jnp.asarray(x), key, dtype=dtype,
                                       use_pallas=False)
    assert tuple(got.shape) == shape and nchunks == jchunks
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nan_propagates_through_the_chunk_max():
    """A NaN value makes its chunk's scale NaN (as jnp.max does) and
    leaves the other chunks alone."""
    x = _planes(14, n=1, rows=16)[0]
    x[3, 5] = np.nan
    u = _dither(15, x.shape)
    _, s = qk.quantize_plain(torch.from_numpy(x), torch.from_numpy(u),
                             127, 8)
    _, sr = jref.quantize_ref(jnp.asarray(x), jnp.asarray(u), 127, 8)
    assert np.isnan(float(s[0, 0])) and np.isnan(np.asarray(sr)[0, 0])
    np.testing.assert_array_equal(s[1:].numpy(), np.asarray(sr)[1:])
    c, err, sc = pu.pack_update_plain(
        torch.from_numpy(x)[None], torch.zeros(16, 128), None,
        torch.from_numpy(u)[None], 127, 8)
    assert torch.isnan(sc[0, 0]) and torch.isnan(c[0, :8]).all()
    assert torch.isfinite(c[0, 8:]).all() and torch.isfinite(err[0, 8:]).all()


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("with_e", [False, True], ids=["no_e", "e"])
@pytest.mark.parametrize("ldtypes", LDTYPES, ids=["f32", "bf16"])
def test_pack_update_plain_bitwise(block, qmax, with_e, ldtypes):
    t_ld, j_ld = ldtypes
    w = np.stack(_planes(16, n=L, rows=QROWS)) * np.float32(0.05)
    g = _planes(17, n=1, rows=QROWS)[0] * np.float32(0.05)
    e = (np.stack(_planes(18, n=L, rows=QROWS)) * np.float32(1e-3)
         if with_e else None)
    u = _dither(19, w.shape)
    tw = torch.from_numpy(w).to(t_ld)
    te = None if e is None else torch.from_numpy(e)
    got = ops.pack_update(tw, torch.from_numpy(g), te, torch.from_numpy(u),
                          qmax=qmax, block=block)
    args = (jnp.asarray(w).astype(j_ld), jnp.asarray(g),
            None if e is None else jnp.asarray(e), jnp.asarray(u))
    want = jref.pack_update_ref(*args, qmax, block)
    assert tuple(got[2].shape) == (L, QROWS // block)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c, err, scales = (np.asarray(x) for x in jpu.pack_update_3d(
        *args, qmax=qmax, block=block, interpret=True))
    np.testing.assert_array_equal(  # the same rounding decisions
        np.rint(got[0].numpy() / np.repeat(got[2].numpy(), block * 128,
                                           axis=1).reshape(w.shape)),
        np.rint(c / np.repeat(scales, block * 128, axis=1).reshape(w.shape)))
    assert np.all(np.abs(got[2].numpy() - scales) <= np.spacing(scales))
    d = _np(tw) - g[None] + (0.0 if e is None else e)
    ulps = _chunk_ulps(d, block)
    assert np.all(np.abs(got[0].numpy() - c) <= PACK_ULPS * ulps)
    assert np.all(np.abs(got[1].numpy() - err) <= PACK_ULPS * ulps)


def test_pack_update_in_place_matches_fresh_outputs():
    """The meta step writes c over the dither and err over the residual."""
    w = np.stack(_planes(20, n=L, rows=QROWS))
    g = _planes(21, n=1, rows=QROWS)[0]
    e = np.stack(_planes(22, n=L, rows=QROWS)) * np.float32(1e-3)
    u = _dither(23, w.shape)
    fresh = ops.pack_update(*_t(w, g, e, u), block=8)
    tw, tg, te, tu = _t(w, g, e, u)
    out = ops.pack_update(tw, tg, te, tu, block=8, c_out=tu, err_out=te)
    assert out[0] is tu and out[1] is te
    for a, b in zip(out, fresh):
        assert torch.equal(a, b)
