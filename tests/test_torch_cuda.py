"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor ``repro``, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import block_momentum as bm  # noqa: E402
from repro_torch.kernels import fused_meta as fm  # noqa: E402
from repro_torch.kernels import local_sgd as sgd  # noqa: E402
from repro_torch.kernels import pack_update as pu  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402

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
    their plain versions, at b = 8 and 64, in place and out of place."""
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
            for block in (8, 64):
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
        wl, gl = w.to(ld), v.to(ld)
        assert torch.equal(sgd.sgd_apply_cuda(wl, gl, 0.1),
                           sgd.sgd_apply_plain(wl, gl, 0.1))
