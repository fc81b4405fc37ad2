"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor ``repro``, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import block_momentum as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_meta as fm  # noqa: E402
from repro_torch.kernels import local_sgd as sgd  # noqa: E402
from repro_torch.kernels import neighbor_mix as nm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pack_update as pu  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.kernels import robust_reduce as rr  # noqa: E402

ROWS = 264  # a multiple of 8 that is not a multiple of the 256-row block
QROWS = 192  # 64 divides it: chunks of 64 rows, or of 8 on request
L = 3


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_comm_kernels_match_plain_bitwise(cuda_device):
    """On the card: quantize, dequantize and pack_update bitwise equal to
    their plain versions, at b = 8 and 64 (pack_update at 32 too), in
    place and out of place."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    x = rand(QROWS, 128)
    u = torch.rand(QROWS, 128, generator=gen, device=cuda_device)
    for block in (8, 64):
        for qmax in (127, 7):
            got = qk.quantize_cuda(x, u, qmax, block)
            want = qk.quantize_plain(x, u, qmax, block)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert torch.equal(qk.dequantize_cuda(*got),
                               qk.dequantize_plain(*got))
    w, e = rand(L, QROWS, 128), rand(L, QROWS, 128) * 1e-3
    uu = torch.rand(L, QROWS, 128, generator=gen, device=cuda_device)
    g = rand(QROWS, 128)
    for ld in (torch.float32, torch.bfloat16):
        for ee in (None, e):
            for block in (8, 32, 64):
                got = pu.pack_update_cuda(w.to(ld), g, ee, uu, 127, block)
                want = pu.pack_update_plain(w.to(ld), g, ee, uu, 127, block)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    want = pu.pack_update_plain(w, g, e, uu, 127, 8)
    got = pu.pack_update_cuda(w, g, e, uu, 127, 8, c_out=uu, err_out=e)
    assert got[0] is uu and got[1] is e
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
        # sgd_apply: a block of threads takes 256 vectors of 16 bytes; in
        # bf16, 264 rows are 16.5 such chunks and 8 rows half of one, so
        # the last block's bounds check runs; in place too
        for rows in (ROWS, 8):
            wl, gl = w[:rows].to(ld), v[:rows].to(ld)
            want = sgd.sgd_apply_plain(wl, gl, 0.1)
            assert torch.equal(sgd.sgd_apply_cuda(wl, gl, 0.1), want)
            assert sgd.sgd_apply_cuda(wl, gl, 0.1, out=wl) is wl
            assert torch.equal(wl, want)


@pytest.mark.cuda
def test_cuda_topology_kernels_match_plain_bitwise(cuda_device):
    """On the card: neighbor_mix (plain and stepped entries, f32 and bf16,
    in place and out of place, L = 1..16) and pack_compress (with and
    without err, b = 8, 16, 32 and 64, in place) bitwise equal to their
    plain versions; pack_compress(d, u) == pack_update(d, 0, None, u).
    b = 16 and 32 put two and four chunks in one block of threads, whose
    max is reduced across warps through shared memory."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for n in (1, 2, 3, 4, 7, 16):
        x = torch.randn(n, QROWS, 128, generator=gen, device=cuda_device)
        w = torch.rand(n, n, generator=torch.Generator().manual_seed(n))
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            want = nm.neighbor_mix_plain(xd, w)
            assert torch.equal(nm.neighbor_mix_cuda(xd, w), want)
            assert nm.neighbor_mix_cuda(xd, w, out=xd) is xd
            assert torch.equal(xd, want)
    stack = torch.rand(3, 4, 4, generator=torch.Generator().manual_seed(9))
    x = torch.randn(4, QROWS, 128, generator=gen, device=cuda_device)
    for step in (0, 4):
        assert torch.equal(nm.neighbor_mix_stepped_cuda(x, stack, step),
                           nm.neighbor_mix_stepped_plain(x, stack, step))
    # the output window: bitwise its plain version and the square call's
    # rows, a NaN learner spreading as there
    for n in (2, 4, 8):
        x = torch.randn(n, QROWS, 128, generator=gen, device=cuda_device)
        x[1, 3, 5] = float("nan")
        w = torch.rand(n, n, generator=torch.Generator().manual_seed(n))
        ws = torch.rand(3, n, n, generator=torch.Generator().manual_seed(n))
        square = nm.neighbor_mix_cuda(x, w)
        for j0 in range(n):
            for m in range(1, n - j0 + 1):
                got = nm.neighbor_mix_cuda(x, w, window=(j0, m))
                want = nm.neighbor_mix_plain(x, w, window=(j0, m))
                assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
                assert torch.equal(got.nan_to_num(7.0),
                                   square[j0:j0 + m].nan_to_num(7.0))
                assert torch.equal(
                    nm.neighbor_mix_stepped_cuda(x, ws, 1, window=(j0, m))
                    .nan_to_num(7.0),
                    nm.neighbor_mix_stepped_plain(x, ws, 1, window=(j0, m))
                    .nan_to_num(7.0))
    d = torch.randn(L, QROWS, 128, generator=gen, device=cuda_device) * 0.05
    u = torch.rand(L, QROWS, 128, generator=gen, device=cuda_device)
    for block in (8, 16, 32, 64):
        for with_err in (True, False):
            got = pu.pack_compress_cuda(d, u, 127, block, with_err=with_err)
            want = pu.pack_compress_plain(d, u, 127, block,
                                          with_err=with_err)
            assert (got[1] is None) == (not with_err)
            assert all(torch.equal(a, b) for a, b in zip(got, want)
                       if b is not None)
        ref = pu.pack_update_cuda(d, torch.zeros_like(d[0]), None, u, 127,
                                  block)
        got = pu.pack_compress_cuda(d, u, 127, block)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for block in (8, 32):
        want = pu.pack_compress_plain(d, u, 127, block)
        dd, uu = d.clone(), u.clone()
        got = pu.pack_compress_cuda(dd, uu, 127, block, c_out=uu, err_out=dd)
        assert got[0] is uu and got[1] is dd
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _specials(x):
    """NaN, +-inf and -0.0 into the first learners' leading values, and a
    column of mixed-sign zeros."""
    f = x.view(x.shape[0], -1)
    f[:, :4] = -0.0
    f[0, 8:16] = float("nan")
    f[1, 12:20] = float("inf")
    f[-1, 16:24] = float("-inf")
    f[:, 24] = torch.tensor([0.0 if j % 2 else -0.0
                             for j in range(x.shape[0])])
    return x


@pytest.mark.cuda
def test_cuda_robust_reduce_matches_plain_bitwise(cuda_device):
    """On the card: the robust-reduce kernel bitwise equal to its plain
    version (NaN where NaN, sign bits of zeros included) for L in
    {2, 3, 4, 5, 8} and every valid trim, on a packed (L, rows, 128)
    stack (4 coordinates a thread), on per-leaf widths that are not a
    multiple of 128 or of 4 (1 a thread), in bf16, into ``out``, and on
    a stack holding NaN, +-inf and -0.0."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def equal(got, want):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok].view(torch.int32),
                           want[ok].view(torch.int32))

    for n in (2, 3, 4, 5, 8):
        for shape in ((QROWS, 128), (1000,), (37, 3)):
            x = torch.randn((n,) + shape, generator=gen, device=cuda_device)
            for xx in (x, _specials(x.clone())):
                for dt in (torch.float32, torch.bfloat16):
                    xd = xx.to(dt)
                    for trim in range(rr.median_trim(n) + 1):
                        equal(rr.robust_reduce_cuda(xd, trim),
                              rr.robust_reduce_plain(xd, trim))
        out = torch.empty(QROWS, 128, device=cuda_device)
        x = torch.randn(n, QROWS, 128, generator=gen, device=cuda_device)
        assert rr.robust_reduce_cuda(x, 1 if n > 2 else 0, out=out) is out
        equal(out, rr.robust_reduce_plain(x, 1 if n > 2 else 0))
    x = torch.randn(16, QROWS, 128, generator=gen, device=cuda_device)
    for trim in (0, 3, 7):
        equal(rr.robust_reduce_cuda(x, trim),
              rr.robust_reduce_plain(x, trim))


def flash_limit(got, plain32):
    """The flash kernel's limit against its plain version's f32 result: in
    f32 |d| <= 1e-5 + 1e-4 |p|; in bf16 one bf16 ulp of p, or the f32 limit
    where that is wider (below ~1.5e-3, where the f32 summation error and
    not the output rounding dominates)."""
    p = plain32.to(torch.float32)
    diff = (got.to(torch.float32) - p).abs()
    limit = 1e-5 + 1e-4 * p.abs()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(p)
        ulp = torch.where(p == 0, torch.zeros_like(p),
                          torch.ldexp(torch.ones_like(p), e - 8))
        limit = torch.maximum(limit, ulp)
    return bool((diff <= limit).all()), float(diff.max())


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda_device):
    """On the card: the flash kernels against the plain version's f32
    result on the same inputs, bf16 through the bf16 Hopper kernel and f32
    through the 3xTF32 one (each counted under its own key), in the
    mask and shape cases of the JAX kernel tests plus a causal D = 256 and
    a D = 80 window, on (B, S, H, D) projections and on a strided view of
    them, through ``ops.flash_attention``."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)

    def bhsd(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])

    cases = [  # (B, Sq, Sk, H, KV, D, kwargs)
        (2, 96, 96, 4, 2, 64, dict(causal=True)),
        (2, 96, 96, 4, 2, 64, dict(causal=False)),
        (1, 128, 128, 4, 2, 80, dict(causal=True, sliding_window=32,
                                     prefix_global=8)),
        (1, 128, 128, 4, 1, 128, dict(causal=True, sliding_window=16,
                                      prefix_global=4)),
        (1, 64, 64, 4, 4, 256, dict(causal=True)),
        (1, 96, 96, 5, 5, 64, dict(causal=True, kv_len=40)),
        (2, 64, 64, 4, 2, 64, dict(causal=True, kv_len=0)),
        (1, 64, 64, 4, 2, 64, dict(causal=True, sliding_window=16,
                                   kv_len=10)),
        (2, 1, 1, 4, 2, 128, dict(causal=True)),
        (1, 33, 70, 4, 2, 112, dict(causal=False)),
        (1, 300, 300, 4, 4, 256, dict(causal=True)),
        (1, 200, 200, 4, 2, 80, dict(causal=True, sliding_window=50)),
    ]
    key = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention"}
    for B, Sq, Sk, H, KV, D, kw in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device=cuda_device)
        k = torch.randn(B, Sk, KV, D, generator=gen, device=cuda_device)
        v = torch.randn(B, Sk, KV, D, generator=gen, device=cuda_device)
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dt) for x in (q, k, v))
            want = fa.flash_attention_plain(
                *(bhsd(x).float() for x in (qd, kd, vd)), **kw)
            ops.reset_launch_counts()
            got = fa.flash_attention_bshd_cuda(qd, kd, vd, **kw)
            assert ops.launch_counts()[key[dt]] == 1
            assert got.dtype == dt and got.shape == q.shape
            ok, err = flash_limit(bhsd(got), want)
            assert ok, (B, Sq, Sk, H, KV, D, kw, dt, err)
    # a strided view (every other head of a wider projection), counted
    q = torch.randn(2, 80, 8, 64, generator=gen, device=cuda_device)
    k = torch.randn(2, 80, 2, 64, generator=gen, device=cuda_device)
    v = torch.randn(2, 80, 2, 64, generator=gen, device=cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dt) for x in (q, k, v))
        ops.reset_launch_counts()
        got = ops.flash_attention(qd[:, :, ::2], kd, vd, causal=True)
        assert ops.launch_counts()[key[dt]] == 1
        ok, err = flash_limit(got, fa.flash_attention_bshd_plain(
            qd[:, :, ::2].float(), kd.float(), vd.float()))
        assert ok, (dt, err)
    # the Hopper kernel's layout check: no fallback, a ValueError
    buf = torch.zeros(q.numel() + 8, dtype=torch.bfloat16,
                      device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bshd_cuda(buf[1:1 + q.numel()].view(q.shape), kd,
                                     vd)


@pytest.mark.cuda
def test_cuda_flash_f32_phase3_cases(cuda_device):
    """On the card: the f32 (3xTF32) Hopper kernel in ``chip_smoke.py``
    phase 3's small f32 cases, at the f32 limit of the plain version, one
    ``flash_attention_f32`` launch each and no bf16 one; a stride of 2
    elements is refused before launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)

    def bhsd(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])

    cases = [  # (B, Sq, Sk, H, KV, D, kwargs)
        (2, 96, 96, 4, 2, 64, dict(causal=False)),
        (2, 128, 128, 4, 2, 64, dict(causal=True, sliding_window=32,
                                     prefix_global=8)),
        (2, 128, 128, 4, 2, 64, dict(causal=True, sliding_window=16,
                                     prefix_global=4)),
        (2, 128, 128, 8, 2, 64, dict(causal=True, kv_len=77)),
        (2, 64, 64, 4, 2, 64, dict(causal=True, kv_len=0)),
        (1, 64, 64, 4, 2, 64, dict(causal=True, sliding_window=16,
                                   kv_len=10)),
        (2, 64, 64, 4, 1, 80, dict(causal=True)),
        (1, 200, 200, 4, 2, 80, dict(causal=True, sliding_window=50)),
        (1, 96, 96, 5, 5, 64, dict(causal=True)),
        (1, 128, 128, 4, 4, 256, dict(causal=False)),
        (1, 300, 300, 4, 4, 256, dict(causal=True)),
        (2, 1, 1, 16, 8, 128, dict(causal=True)),
        (1, 33, 70, 4, 2, 112, dict(causal=False)),
        (1, 100, 60, 4, 2, 128, dict(causal=True, sliding_window=8)),
    ]
    for B, Sq, Sk, H, KV, D, kw in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device=cuda_device)
        k = torch.randn(B, Sk, KV, D, generator=gen, device=cuda_device)
        v = torch.randn(B, Sk, KV, D, generator=gen, device=cuda_device)
        ops.reset_launch_counts()
        got = fa.flash_attention_bshd_cuda(q, k, v, **kw)
        counts = ops.launch_counts()
        assert counts["flash_attention_f32"] == 1
        assert counts["flash_attention"] == 0
        want = fa.flash_attention_plain(*(bhsd(x) for x in (q, k, v)), **kw)
        ok, err = flash_limit(bhsd(got), want)
        assert ok, (B, Sq, Sk, H, KV, D, kw, err)
    wide = torch.zeros(2, 16, 4, 66, device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="multiples of 4"):
        fa.flash_attention_bshd_cuda(wide, wide, wide)


@pytest.mark.cuda
def test_cuda_serving_matches_cpu(cuda_device):
    """Reduced Qwen3 in f32: prefill through the flash kernel and 4 decode
    steps on the card against the CPU, same params and prompt."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gparams = tree_map(lambda t: t.to(cuda_device), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ops.reset_launch_counts()
        lg, cg = api.prefill(gparams, cfg, {"tokens": toks.to(cuda_device)},
                             20, use_pallas=True)
        assert ops.launch_counts()["flash_attention_f32"] == cfg.num_layers
        lc, cc = api.prefill(params, cfg, {"tokens": toks}, 20,
                             use_pallas=True)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cg["k"].cpu(), cc["k"], rtol=1e-5,
                                   atol=1e-5)
        nxt = torch.argmax(lc, -1).to(torch.int32)
        for _ in range(4):
            lg, cg = api.decode_step(gparams, cfg, cg, nxt.to(cuda_device))
            lc, cc = api.decode_step(params, cfg, cc, nxt)
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
            nxt = torch.argmax(lc, -1).to(torch.int32)
        got = serve.generate(gparams, cfg, toks.to(cuda_device), 6, 24,
                             use_pallas=True)
        want = serve.generate(params, cfg, toks, 6, 24, use_pallas=True)
        assert torch.equal(got.cpu(), want)


def _no_tf32():
    """Full float32 matmuls and convolutions on the card, as on the CPU;
    returns the previous flags."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per-leaf"])
def test_cuda_cnn_meta_steps_match_cpu(cuda_device, packed):
    """On the card: two M-AVG meta steps of E1's CNN (hw=12, L=2, K=2)
    against the CPU from the same params and CPU-drawn batches, TF32 off,
    within rtol 1e-5 / atol 1e-6, through the meta kernels."""
    from repro_torch.configs.base import MAvgConfig
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.data import classif_batch_fn
    from repro_torch.models.simple import cnn_init, cnn_loss
    from repro_torch.utils.tree import tree_leaves, tree_map

    prev = _no_tf32()
    try:
        gen = torch.Generator().manual_seed(0)
        params = cnn_init(gen, hw=12, device="cpu")
        bf = classif_batch_fn(12 * 12 * 3, 10, 2, 2, 8, device="cpu")
        batches = [bf(torch.Generator().manual_seed(1 + i), i)
                   for i in range(2)]
        batches = [{"x": b["x"].reshape(2, 2, 8, 12, 12, 3), "y": b["y"]}
                   for b in batches]
        cfg = MAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                         learner_lr=0.1, momentum=0.7, packed=packed)
        runs = {}
        for dev in ("cpu", cuda_device):
            state = init_state(tree_map(lambda x: x.to(dev), params), cfg)
            step = make_meta_step(cnn_loss, cfg)
            ops.reset_launch_counts()
            losses = []
            for b in batches:
                state, m = step(state, {k: v.to(dev) for k, v in b.items()})
                losses.append(float(m["loss"]))
            runs[str(dev)] = (losses, state, ops.launch_counts())
        (cl, cs, cc), (gl, gs, gc) = runs["cpu"], runs["cuda"]
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                                   rtol=1e-5, atol=1e-6)
        for field in ("global_params", "momentum", "learners"):
            for a, b in zip(tree_leaves(getattr(gs, field)),
                            tree_leaves(getattr(cs, field))):
                torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        assert sum(cc.values()) == 0
        assert gc["sgd_apply"] > 0
        assert gc["fused_momentum_broadcast" if packed
                  else "block_momentum"] > 0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path, compute_dtype):
    """On the card: a state saved after one meta step verifies, restores
    in place into a fresh state on the card bitwise, and the next step
    from both gives the same loss."""
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.checkpoint import verify_checkpoint
    from repro_torch.checkpoint.npz import _entries
    from repro_torch.configs.base import MAvgConfig
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models.simple import mlp_init, mlp_loss

    cfg = MAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                     learner_lr=0.1, momentum=0.7,
                     compute_dtype=compute_dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def batch():
        return {"x": torch.randn(2, 2, 4, 8, generator=gen,
                                 device=cuda_device),
                "y": torch.randint(0, 4, (2, 2, 4), generator=gen,
                                   device=cuda_device)}

    def fresh(seed):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        return init_state(mlp_init(g, 8, 16, 4, device=cuda_device), cfg)

    step = make_meta_step(mlp_loss, cfg)
    state, _ = step(fresh(1), batch())
    path = save_state(str(tmp_path), state, 1)
    verify_checkpoint(path)
    template = fresh(2)
    ptrs = [x.data_ptr() for _, x in _entries(template)
            if isinstance(x, torch.Tensor)]
    restored = load_state(path, template)
    assert restored.step == 1
    for (k, a), (_, b) in zip(_entries(state), _entries(restored)):
        if isinstance(a, torch.Tensor):
            assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b), k
    assert [x.data_ptr() for _, x in _entries(restored)
            if isinstance(x, torch.Tensor)] == ptrs
    b = batch()
    _, m1 = step(state, b)
    _, m2 = step(restored, b)
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_bigram_table_on_the_generators_device(cuda_device):
    """The bigram stream builds its table on the generator's device."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import bigram_table, lm_batch_fn

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    assert bigram_table(gen, 16).device.type == "cuda"
    cfg = get_config("qwen3-1.7b").reduced()
    b = lm_batch_fn(cfg, 2, 2, 2, 8, device=cuda_device)(
        torch.Generator(device=cuda_device).manual_seed(1), 0)
    assert b["tokens"].device.type == "cuda"
    assert b["tokens"].shape == (2, 2, 2, 8)


@pytest.mark.cuda
def test_cuda_telemetry_run_reads_once_per_flush(cuda_device, tmp_path):
    """Three reduced Qwen3 meta steps on the card with the JSONL sink: the
    ring lies on the card, the host reads it once per flush, and the log
    passes tools/check_telemetry.py."""
    import importlib.util
    import json
    import os

    from repro_torch.configs.base import (
        MAvgConfig,
        ObsConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api

    cfg = get_config("qwen3-1.7b").reduced()
    run_dir = str(tmp_path / "run")
    tcfg = TrainConfig(
        model=cfg, mavg=MAvgConfig(algorithm="mavg", num_learners=2,
                                   k_steps=2),
        batch_per_learner=2, seq_len=16, meta_steps=3, log_every=2,
        obs=ObsConfig(sink="jsonl", run_dir=run_dir, trace=True,
                      health=True))
    trainer = Trainer(
        tcfg, lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, cuda_device),
        batch_fn=uniform_batch_fn(cfg, 2, 2, 2, 16), device=cuda_device)
    history = trainer.run(log=None)
    trainer.close()
    assert trainer._mb.buf.is_cuda
    assert trainer._mb.host_syncs == 2  # steps 0-1 (ring full), then 2
    assert [h["meta_step"] for h in history] == [0, 1, 2]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", os.path.join(root, "tools", "check_telemetry.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    schema = ct.load_schema(os.path.join(root, "tools",
                                         "telemetry_schema.json"))
    assert ct.check_file(os.path.join(run_dir, "run.jsonl"), schema) == []
    man = json.loads(open(os.path.join(run_dir, "run.jsonl")).readline())
    assert man["backend"] == "cuda" and man["jax_version"] is None
    assert man["devices"][0] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_cuda_supervised_recovery_ends_finite(cuda_device, tmp_path):
    """A NaN batch on learner 0 at step 3 halts the MLP run on the card;
    the supervisor rolls back to step 2 and the retry ends finite."""
    from repro_torch.chaos import ChaosConfig, FaultSpec
    from repro_torch.configs.base import MAvgConfig, ObsConfig, TrainConfig
    from repro_torch.core.supervisor import Supervisor
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.synthetic import classif_batch_fn
    from repro_torch.models.simple import mlp_init, mlp_loss

    ckpt = str(tmp_path / "ck")
    chaos = ChaosConfig(seed=0, horizon=6, faults=(
        FaultSpec("nan_batch", step=3, learner=0),))

    def make(plan):
        return Trainer(
            TrainConfig(
                model=None,
                mavg=MAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                                learner_lr=0.1 * plan.lr_scale,
                                momentum=0.6, finite_guard=True),
                batch_per_learner=4, meta_steps=6, log_every=1,
                checkpoint_dir=ckpt, checkpoint_every=2, chaos=chaos,
                data_salt=plan.data_salt,
                obs=ObsConfig(sink="jsonl", run_dir=str(tmp_path / "run"),
                              health=True)),
            mlp_loss,
            init_params_fn=lambda gen: mlp_init(gen, 8, 16, 4,
                                                device=cuda_device),
            batch_fn=classif_batch_fn(8, 4, 2, 2, 4, device=cuda_device),
            device=cuda_device)

    sup = Supervisor(make, target_steps=6, checkpoint_dir=ckpt)
    trainer, _ = sup.run(log=None)
    trainer.close()
    assert trainer.state.step == 6
    for x in (trainer.state.global_params, trainer.state.momentum,
              trainer.state.learners):
        assert x.is_cuda and bool(torch.isfinite(x).all())
    kinds = [(r["kind"], r.get("fault"), r.get("learner"), r["meta_step"])
             for r in sup.records]
    assert kinds[:2] == [("fault", "nonfinite_loss", 0, 4),
                         ("recovery", None, None, 2)]


@pytest.mark.cuda
def test_cuda_profile_clone_refuses_what_does_not_fit(cuda_device,
                                                      monkeypatch):
    """``profile_phases`` times a clone of the state; a clone that would
    not fit the card's free memory raises instead of running out of
    memory mid-profile."""
    from repro_torch.configs.base import MAvgConfig
    from repro_torch.core.meta import init_state
    from repro_torch.models.simple import mlp_init
    from repro_torch.obs import profile

    g = torch.Generator(device=cuda_device).manual_seed(0)
    state = init_state(mlp_init(g, 8, 16, 4, device=cuda_device),
                       MAvgConfig(num_learners=2, k_steps=2))
    assert profile.clone_state(state).global_params.is_cuda
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (0, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    with pytest.raises(ValueError, match="does not fit"):
        profile.clone_state(state)


@pytest.mark.cuda
def test_cuda_async_server_main_path(cuda_device):
    """Phase 14b's assertions at the reduced model's size: the async mavg
    server on profile (1, 1, 2, 4), tau 3, L=4, K=2, 12 ticks on the card:
    staleness <= tau and fired counts equal to the host replay on every
    tick, sgd_apply launched K times per completed block, no fused
    momentum-broadcast launch on this non-degenerate path, every plane
    finite; then the uniform profile bitwise equal to the flat topology,
    with one fused launch a tick."""
    import dataclasses

    from repro_torch.configs.base import (
        AsyncConfig,
        MAvgConfig,
        TopologyConfig,
        get_config,
    )
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models import api
    from repro_torch.topology import make_topology

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg, "cpu")
    Lr, K, ticks = 4, 2, 12
    batches = [{"tokens": t.to(cuda_device), "labels": t.to(cuda_device)}
               for t in (torch.randint(0, cfg.vocab_size, (Lr, K, 2, 16),
                                       generator=gen)
                         for _ in range(ticks))]

    def loss_fn(p, b):
        return api.loss_fn(p, cfg, b)

    def run(mcfg, n):
        topology = make_topology(mcfg)
        state = init_state(_to(params, cuda_device), mcfg,
                           topology=topology)
        step = make_meta_step(loss_fn, mcfg, topology=topology)
        ops.reset_launch_counts()
        metrics = []
        for b in batches[:n]:
            state, m = step(state, b)
            metrics.append(m)
        return state, metrics, topology, ops.launch_counts()

    base = dict(algorithm="mavg", num_learners=Lr, k_steps=K,
                learner_lr=0.1, momentum=0.7)
    mcfg = MAvgConfig(**base, topology=TopologyConfig(
        kind="async", server=AsyncConfig(staleness=3,
                                         step_time=(1, 1, 2, 4))))
    state, metrics, topo, counts = run(mcfg, ticks)
    done = [topo.work_completed(i) for i in range(ticks)]
    fired = [b - a for a, b in zip([0] + done, done)]
    assert [m["fired_count"] for m in metrics] == fired
    assert all(m["staleness_max"] <= 3 for m in metrics)
    assert counts["sgd_apply"] == K * done[-1]
    assert counts["fused_momentum_broadcast"] == 0
    for t in (state.global_params, state.momentum, state.learners,
              state.topo["anchor"]):
        assert bool(torch.isfinite(t).all())
    flat, _, _, fc = run(MAvgConfig(**base), 2)
    uni, _, _, uc = run(MAvgConfig(**base, topology=TopologyConfig(
        kind="async", server=AsyncConfig())), 2)
    assert fc["fused_momentum_broadcast"] == uc["fused_momentum_broadcast"] == 2
    for f in ("global_params", "momentum", "learners"):
        assert torch.equal(getattr(flat, f), getattr(uni, f)), f


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_sweep_cells_match_the_cpu(cuda_device):
    """E2's, E3's and the comm bench's ``run_mlp`` cells on the card
    against the CPU on the same CPU-drawn inputs (dense: losses rtol 1e-5,
    accuracy within one of 2,048 examples), each launching the fused
    meta update once a meta step and ``sgd_apply`` once a local step of a
    learner."""
    from repro_torch.benchmarks.common import CLASSES, D_IN, HIDDEN, run_mlp
    from repro_torch.data import classif_batch_fn, classif_eval_set
    from repro_torch.models.simple import mlp_init

    for P, K, mu, steps in ((16, 4, 0.5, 6), (4, 16, 0.7, 3), (4, 1, 0.0, 8)):
        gen = torch.Generator().manual_seed(P * K)
        params = mlp_init(gen, D_IN, HIDDEN, CLASSES, device="cpu")
        bf = classif_batch_fn(D_IN, CLASSES, P, K, 8, device="cpu")
        batches = [bf(torch.Generator().manual_seed(i), i)
                   for i in range(steps)]
        ev = classif_eval_set(D_IN, CLASSES, device="cpu")
        runs = {}
        for dev in ("cpu", cuda_device):
            ops.reset_launch_counts()
            runs[str(dev)] = run_mlp(
                "mavg", P=P, K=K, mu=mu, lr=0.15, steps=steps, batch=8,
                device=dev, params=_to(params, dev),
                batch_at=lambda i, d=dev: _to(batches[i], d),
                eval_set=_to(ev, dev)) + (ops.launch_counts(),)
        (cl, ca, cc), (gl, ga, gc) = runs["cpu"], runs["cuda"]
        assert sum(cc.values()) == 0
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                                   rtol=1e-5, atol=1e-6)
        assert abs(ga - ca) <= 1 / 2048 + 1e-9
        assert gc["fused_momentum_broadcast"] == steps
        assert gc["sgd_apply"] == steps * P * K


@pytest.mark.cuda
def test_cuda_gated_benches_hold_their_bars(cuda_device):
    """The robust bench (quick) and the modeled rows of the topology and
    async benches on the card, checked with the port's ``obs.baseline``
    against ``benchmarks/expected/{robust,topology,async}.json`` where
    the rows exist; the robust arm runs under the Supervisor with no
    rollback and launches the robust_reduce kernel."""
    import json
    import os

    from repro_torch.benchmarks import async_bench, robust_bench
    from repro_torch.benchmarks import topology_bench
    from repro_torch.benchmarks.common import envelope
    from repro_torch.obs.baseline import compare

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def spec(suite):
        with open(os.path.join(root, "benchmarks", "expected",
                               f"{suite}.json")) as f:
            return json.load(f)

    ops.reset_launch_counts()
    rows = robust_bench.main(quick=True, device=cuda_device)
    assert ops.launch_counts()["robust_reduce"] > 0
    assert compare(envelope(rows), spec("robust")) == []
    assert rows[-1]["rollbacks"] == 0 and rows[-1]["ok"]
    topo = {**spec("topology"), "metrics": [
        m for m in spec("topology")["metrics"]
        if m["select"]["row_kind"] != "topo_measured"]}
    assert compare(envelope(topology_bench.modeled()), topo) == []
    model = {**spec("async"), "metrics": [
        m for m in spec("async")["metrics"]
        if m["select"]["row_kind"] == "async_model"]}
    assert compare(envelope(async_bench.modeled()), model) == []


@pytest.mark.cuda
def test_cuda_examples_run_on_the_card(cuda_device):
    """``train_100m`` at its small width for 2 meta steps and
    ``serve_batch`` on every decode-capable reduced arch, on the card: finite
    planes, a loss, greedy tokens of the right shape."""
    from repro_torch.examples import serve_batch, train_100m

    ops.reset_launch_counts()
    trainer, hist, loss, n = train_100m.main(
        ["--steps", "2", "--learners", "2", "--k", "2", "--batch", "2",
         "--seq", "32"])
    counts = ops.launch_counts()
    assert counts["fused_momentum_broadcast"] == 2
    assert counts["sgd_apply"] == 2 * 2 * 2
    assert n == 6_031_616 and loss == loss
    for t in (trainer.state.global_params, trainer.state.momentum,
              trainer.state.learners):
        assert bool(torch.isfinite(t).all())
    out = serve_batch.main(["--tokens", "4"])
    served = {a: t for a, t in out.items() if t is not None}
    assert sorted(served) == ["deepseek-moe-16b", "hymba-1.5b",
                              "internvl2-76b", "kimi-k2-1t-a32b",
                              "llama3-405b", "qwen1.5-110b", "qwen2-7b",
                              "qwen3-1.7b", "xlstm-350m"]
    assert all(t.shape == (2, 4) and t.is_cuda for t in served.values())


def _moe_cfg(arch="deepseek-moe-16b"):
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


@pytest.mark.cuda
def test_cuda_moe_layer_matches_the_cpu(cuda_device):
    """The MoE layer on the card against the CPU, f32 with TF32 off, with
    capacity dropping and dropless: the routing integers equal, the output,
    aux loss and gradients within rtol 1e-5 / atol 1e-6 (the combine's
    ``index_add`` is atomic on the card, so not bitwise)."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for arch in ("deepseek-moe-16b", "kimi-k2-1t-a32b"):
        for cf, dropless in ((1.25, False), (0.01, False), (1.25, True)):
            cfg = dataclasses.replace(_moe_cfg(arch), capacity_factor=cf)
            p = moe.init_moe(gen, cfg, "cpu")
            x = torch.randn((2, 16, cfg.d_model), generator=gen) * 0.5
            results = []
            for dev in ("cpu", cuda_device):
                pd = tree_map(lambda t: t.to(dev, copy=True)
                              .requires_grad_(True), p)
                xd = x.to(dev)
                route = moe._route(xd.view(-1, cfg.d_model), pd, cfg,
                                   dropless)
                out, aux = moe.moe_layer(xd, pd, cfg, dropless)
                (out.square().sum() + aux).backward()
                results.append((route, out, aux, tree_leaves(pd)))
            (rc, oc, ac, pc), (rg, og, ag, pg) = results
            assert rc[5] == rg[5]
            for a, b in zip(rc[1:4], rg[1:4]):
                assert torch.equal(a, b.cpu())
            tol = dict(rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(og.detach().cpu(), oc.detach(), **tol)
            torch.testing.assert_close(ag.detach().cpu(), ac.detach(), **tol)
            for a, b in zip(pc, pg):
                torch.testing.assert_close(b.grad.cpu(), a.grad,
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_moe_prefill_matches_the_cpu(cuda_device):
    """A reduced DeepSeekMoE prefill on the card (the f32 flash kernel,
    one launch a layer) against the CPU's plain version, then 4 decode
    steps: logits and cache within rtol = atol = 1e-5, greedy tokens
    equal."""
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg()
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gparams = tree_map(lambda t: t.to(cuda_device), params)
    toks = torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    tol = dict(rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        ops.reset_launch_counts()
        lg, cg = api.prefill(gparams, cfg, {"tokens": toks.to(cuda_device)},
                             24, use_pallas=True)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention_f32"] == cfg.num_layers
        lc, cc = api.prefill(params, cfg, {"tokens": toks}, 24,
                             use_pallas=True)
        for g, c in ((lg, lc), (cg["k"], cc["k"]), (cg["v"], cc["v"])):
            torch.testing.assert_close(g.cpu(), c, **tol)
        nxt = torch.argmax(lc, -1).to(torch.int32)
        for _ in range(4):
            lg, cg = api.decode_step(gparams, cfg, cg, nxt.to(cuda_device))
            lc, cc = api.decode_step(params, cfg, cc, nxt)
            torch.testing.assert_close(lg.cpu(), lc, **tol)
            assert torch.equal(torch.argmax(lg, -1).cpu(),
                               torch.argmax(lc, -1))
            nxt = torch.argmax(lc, -1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_cuda_hybrid_and_ssm_match_the_cpu(cuda_device, arch):
    """The reduced Hymba and xLSTM on the card against the CPU, f32 with
    TF32 off: logits, loss and every gradient, then the prefill's logits
    and cache and 4 decode steps, within rtol = atol = 1e-5 (the loss
    rtol 1e-5 / atol 1e-6); greedy tokens equal."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = api.make_batch(torch.Generator().manual_seed(1), cfg, 2, 16)
    tol = dict(rtol=1e-5, atol=1e-5)
    out = []
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(True),
                     params)
        b = tree_map(lambda t: t.to(dev), batch)
        with torch.no_grad():
            logits, _ = api.forward(p, cfg, b)
        loss, _ = api.loss_fn(p, cfg, b)
        loss.backward()
        out.append((logits, loss.detach(), [t.grad for t in tree_leaves(p)]))
    (lc, xc, gc), (lg, xg, gg) = out
    torch.testing.assert_close(lg.cpu(), lc, **tol)
    torch.testing.assert_close(xg.cpu(), xc, rtol=1e-5, atol=1e-6)
    for a, b in zip(gc, gg):
        torch.testing.assert_close(b.cpu(), a, **tol)
    gparams = tree_map(lambda t: t.to(cuda_device), params)
    prompt = batch["tokens"]
    with torch.no_grad():
        lg, cg = api.prefill(gparams, cfg, {"tokens": prompt.to(cuda_device)},
                             24)
        lc, cc = api.prefill(params, cfg, {"tokens": prompt}, 24)
        torch.testing.assert_close(lg.cpu(), lc, **tol)
        for key, c in cc.items():  # xLSTM's entries are tuples of states
            g = cg[key]
            g = tuple(t.cpu() for t in g) if isinstance(g, tuple) else g.cpu()
            torch.testing.assert_close(g, c, **tol)
        nxt = torch.argmax(lc, -1).to(torch.int32)
        for _ in range(4):
            lg, cg = api.decode_step(gparams, cfg, cg, nxt.to(cuda_device))
            lc, cc = api.decode_step(params, cfg, cc, nxt)
            torch.testing.assert_close(lg.cpu(), lc, **tol)
            assert torch.equal(torch.argmax(lg, -1).cpu(),
                               torch.argmax(lc, -1))
            nxt = torch.argmax(lc, -1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("comm", ["dense", "int8"])
def test_cuda_cost_model_matches_the_card(cuda_device, comm):
    """The cost model (``roofline.cost.jit_cost``, on meta copies of the
    state) against one meta step of the reduced dense model on the card,
    after a warm-up step: the modeled kernel calls equal the launches,
    the modeled matmul flops equal ``torch.profiler``'s, and the modeled
    peak of the step's own allocations is within 5 % (and 8 MiB of the
    allocator's 512-byte rounding) of the card's."""
    from repro_torch.configs.base import (
        CommConfig,
        MAvgConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.roofline.cost import jit_cost, profiled_matmul_flops

    cfg = get_config("qwen3-1.7b").reduced()
    mcfg = MAvgConfig(num_learners=2, k_steps=2,
                      comm=CommConfig(scheme=comm))
    trainer = Trainer(
        TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=2, seq_len=16,
                    meta_steps=1),
        lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, cuda_device),
        batch_fn=uniform_batch_fn(cfg, 2, 2, 2, 16), device=cuda_device)

    def step(s, b):
        return trainer._step_fn(s, b, lr=0.01)

    def batch(i):
        return trainer.batch_fn(trainer._data_generator(i), i)

    trainer.state, _ = step(trainer.state, batch(0))  # warm-up
    b1 = batch(1)
    jc = jit_cost(step, trainer.state, b1, in_place=(0,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    trainer.state, _ = step(trainer.state, b1)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - before
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    assert launched == jc.kernel_calls
    modeled = jc.peak_state_bytes - jc.arg_bytes  # the step's allocations
    assert abs(measured - modeled) <= 0.05 * modeled + (8 << 20), (
        measured, modeled)
    _, flops = profiled_matmul_flops(step, trainer.state, batch(2))
    assert flops == jc.flops > 0


PLACED_SCRIPT = r'''
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import MAvgConfig, get_config
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.data import uniform_batch_fn
from repro_torch.kernels import ops
from repro_torch.launch import specs as S
from repro_torch.models import api
from repro_torch.sharding import Spec
from repro_torch.sharding.placed import Placement, placed_meta_step
from repro_torch.utils.rng import seeded_generator

dist.init_process_group("nccl", init_method="tcp://localhost:" + sys.argv[1],
                        world_size=1, rank=0)
try:
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("qwen3-1.7b").reduced()
    L, K = 4, 2
    mcfg = MAvgConfig(num_learners=L, k_steps=K)
    loss = lambda p, b: api.loss_fn(p, cfg, b)
    params = api.init_params(seeded_generator("cuda", 19, 0), cfg, "cuda")
    ref, mine = init_state(params, mcfg), init_state(params, mcfg)
    batch_fn = uniform_batch_fn(cfg, L, K, 2, 16)
    batches = [batch_fn(seeded_generator("cuda", 19, 1 + i), i)
               for i in range(2)]
    step = make_meta_step(loss, mcfg)
    ops.reset_launch_counts()
    for b in batches:
        ref, _ = step(ref, b, lr=0.01)
    unplaced = ops.launch_counts()
    placement = Placement(mesh, ("data",))
    st = S.place_tree(mine, S.state_shardings(cfg, mcfg, mesh), mesh)
    ops.reset_launch_counts()
    for b in batches:
        bt = {k: S.place(v, Spec("data"), mesh) for k, v in b.items()}
        st, _ = placed_meta_step(st, bt, loss_fn=loss, cfg=mcfg,
                                 placement=placement, lr=0.01)
    placed = ops.launch_counts()
    torch.cuda.synchronize()
    print(json.dumps({
        "equal": all(torch.equal(getattr(st, f).to_local(), getattr(ref, f))
                     for f in ("global_params", "momentum", "learners")),
        "unplaced": unplaced, "placed": placed}))
finally:
    dist.destroy_process_group()
'''


@pytest.mark.cuda
def test_cuda_placed_step_on_a_one_gpu_mesh_is_the_unplaced_step(
        cuda_device):
    """``chip_smoke.py`` phase 19b at the reduced width: the state placed
    by ``specs.state_shardings`` on a (1, 1) NCCL DeviceMesh (a process of
    its own, so its group ends with it) steps bitwise as the unplaced
    state, with as many kernel launches."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", PLACED_SCRIPT, str(port)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["equal"], out
    assert out["placed"] == out["unplaced"]
    assert out["placed"]["sgd_apply"] == 2 * 2 * 4
    assert out["placed"]["fused_momentum_broadcast"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "hier_elastic", "robust", "guard",
                                  "per_leaf", "gossip", "async"])
def test_cuda_placed_configurations_on_a_one_gpu_mesh(cuda_device, name):
    """``chip_smoke.py`` phase 19b's program at the reduced width for the
    configurations newly placed: int8 + EF (``pack_update``),
    hierarchical elastic with int8 inner (``pack_compress``,
    ``block_momentum``), robust with a scaled payload (``robust_reduce``),
    the finite guard with a NaN learner, per-leaf planes
    (``block_momentum`` a leaf), gossip on the ring with momentum
    tracking and int8 + EF (``pack_compress``, ``neighbor_mix``) and the
    async server on the profile (1, 1, 2, 4), on a (1, 1) NCCL DeviceMesh:
    planes, residual and topology buffers bitwise the unplaced step's,
    every metric equal, and as many launches of each kernel."""
    import json
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    args = [str(x) for x in (1, 4, 2, 2, 16, 2, port, 0.1, "cuda", "nccl",
                             "reduced", name)]
    proc = subprocess.run(
        [sys.executable, "-c", chip_smoke.PLACED_STEP_SCRIPT, *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(out["equal"].values()) and out["metrics_equal"], out
    assert out["placed"] == out["unplaced"], out
    for kernel in chip_smoke.PLACED_KERNELS[name]:
        assert out["placed"].get(kernel, 0) > 0, (kernel, out)


@pytest.mark.cuda
def test_cuda_traced_run_times_the_local_step_on_the_device(cuda_device):
    """Reduced Qwen3 on the card with the Tracer on: every local step's
    forward, backward and update get a ``.device`` span after each flush,
    in turn on the card, after the host's local phase began; the
    dispatch spans carry the allocator counters; the profiler sees the
    phases as host ranges only, with no copy on the card's timeline."""
    from repro_torch.configs.base import (
        MAvgConfig,
        ObsConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.obs.trace import ALLOC_COUNTERS

    cfg = get_config("qwen3-1.7b").reduced()
    nl, k = 2, 2

    def trainer(trace):
        tcfg = TrainConfig(
            model=cfg, mavg=MAvgConfig(algorithm="mavg", num_learners=nl,
                                       k_steps=k),
            batch_per_learner=2, seq_len=16, meta_steps=3, log_every=1,
            obs=ObsConfig(trace=trace))
        return Trainer(
            tcfg, lambda p, b: api.loss_fn(p, cfg, b),
            init_params_fn=lambda gen: api.init_params(gen, cfg,
                                                       cuda_device),
            batch_fn=uniform_batch_fn(cfg, nl, k, 2, 16),
            device=cuda_device)

    on, off = trainer(True), trainer(False)
    off.run(log=None)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        on.run(log=None)
        torch.cuda.synchronize()
    assert off.tracer.events == []
    assert [h["loss"] for h in off.history] == [h["loss"] for h in on.history]
    t = on.tracer
    assert t._pending == []
    rows = [(n, a["step"], t0, d, a) for (n, t0, d), a in zip(t.events,
                                                              t.args)]
    for step in range(3):
        def of(name):
            return [r for r in rows if r[0] == name and r[1] == step]

        (host_local,) = of("obs.local_phase")
        names = ("obs.forward", "obs.backward", "obs.update")
        for name in names:
            dev, host = of(name + ".device"), of(name)
            assert len(dev) == len(host) == nl * k, name
            for d, h in zip(dev, host):
                assert d[3] > 0 and d[2] >= h[2] - 1e-3, (name, d, h)
                assert d[4]["parent"] == "obs.local_phase"
                assert d[2] >= host_local[2] - 1e-3
        # one stream: the local steps' phases run in turn on the card
        dev = sorted((r for n in names for r in of(n + ".device")),
                     key=lambda r: r[2])
        assert [r[0] for r in dev] == [n + ".device" for n in names] * (nl * k)
        for a, b in zip(dev, dev[1:]):
            assert b[2] >= a[2] + a[3] - 1e-4, (a, b)
        (disp,) = of("obs.dispatch")
        assert set(ALLOC_COUNTERS) <= set(disp[4])
        # the local phase and the mix are host spans only
        assert of("obs.local_phase.device") == of("obs.meta_mix.device") == []
    on_card = {e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() != torch.autograd.DeviceType.CPU}
    on_host = {e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CPU}
    phases = {"obs.forward", "obs.backward", "obs.update", "obs.data"}
    assert phases <= on_host
    assert not phases & on_card, phases & on_card
