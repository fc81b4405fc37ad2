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

The CUDA kernels (built with no FMA contraction) are held bitwise to the
plain versions on the card by ``chip_smoke.py`` and by the ``cuda``-marked
test at the end, which skips without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import block_momentum as bm  # noqa: E402
from repro_torch.kernels import fused_meta as fm  # noqa: E402
from repro_torch.kernels import local_sgd as sgd  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


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
    route, and a missing nvcc is an error, not a silent plain run."""
    w, g = _t(*_planes(6, n=2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgd.sgd_apply_cuda(w, g, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.fused_momentum_broadcast_cuda(w, g, g, 0.7, 1.0, 2,
                                         torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bm.block_momentum_cuda(w, g, g, 0.7, 1.0)
    meta = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.sgd_apply(meta, meta, 0.1)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "_LIBRARY", None)
    monkeypatch.setattr(build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()


def test_launch_counter_counts_kernel_launches_only():
    ops.reset_launch_counts()
    ops.sgd_apply(*_t(*_planes(7, n=2)), 0.1)  # CPU: the plain version
    assert ops.launch_counts() == {"fused_momentum_broadcast": 0,
                                   "block_momentum": 0, "sgd_apply": 0}


@pytest.mark.cuda
def test_cuda_kernels_match_plain_bitwise(cuda_device):
    """On the card: every kernel bitwise equal to its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w, v, a = (torch.randn(ROWS, 128, generator=gen, device=cuda_device)
               for _ in range(3))
    for ld in (torch.float32, torch.bfloat16):
        for nesterov in (False, True):
            got = fm.fused_momentum_broadcast_cuda(w, v, a, 0.7, 1.0, L, ld,
                                                   nesterov=nesterov)
            want = fm.fused_momentum_broadcast_plain(w, v, a, 0.7, 1.0, L,
                                                     ld, nesterov=nesterov)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
            got = bm.block_momentum_cuda(w, v, a, 0.7, 1.0,
                                         nesterov=nesterov)
            want = bm.block_momentum_plain(w, v, a, 0.7, 1.0,
                                           nesterov=nesterov)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        wl, gl = w.to(ld), v.to(ld)
        assert torch.equal(sgd.sgd_apply_cuda(wl, gl, 0.1),
                           sgd.sgd_apply_plain(wl, gl, 0.1))
