"""The port's roofline terms (``repro_torch.roofline.terms``) against the
JAX package's ``repro.roofline.terms``, and the kernels' declared costs.

* ``model_flops`` equals JAX's for every arch and input shape, at
  k_steps 1 and 4.
* ``compute_terms(...).to_dict()`` equals JAX's field for field when the
  port is handed a ``Rates`` built here from JAX's TPU constants (flat,
  compressed, hierarchical, gossip, async; per device and not); with its
  default ``H100_SXM`` the terms are the data sheet's.
* ``H100_SXM`` holds the H100 SXM data sheet's rates, and
  ``kernel_bound`` of each kernel's declared cost at the main path's
  shapes gives the bound column of PERF.md section 6 (the numbers
  ``chip_smoke.py`` printed from its own formulas before it read the
  declared costs).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.roofline import terms as jterms  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import block_momentum as bm  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_meta as fm  # noqa: E402
from repro_torch.kernels import local_sgd as sgd  # noqa: E402
from repro_torch.kernels import neighbor_mix as nm  # noqa: E402
from repro_torch.kernels import pack_update as pu  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.kernels import robust_reduce as rr  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.pack import make_pack_spec  # noqa: E402
from repro_torch.roofline import terms  # noqa: E402

JAX_RATES = terms.Rates(
    name="the JAX package's TPU constants",
    hbm_bytes_per_s=jterms.HBM_BW,
    f32_flops_per_s=jterms.PEAK_FLOPS_BF16,
    tf32_flops_per_s=jterms.PEAK_FLOPS_BF16,
    bf16_flops_per_s=jterms.PEAK_FLOPS_BF16,
    intra_link_bytes_per_s=jterms.ICI_LINK_BW,
    inter_link_bytes_per_s=jterms.DCN_LINK_BW,
)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_model_flops_equal_jax(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for name, shape in tbase.INPUT_SHAPES.items():
        for k in (1, 4):
            assert terms.model_flops(tcfg, shape, k) == jterms.model_flops(
                jcfg, jbase.INPUT_SHAPES[name], k), (name, k)


def _topologies(base):
    comm = base.CommConfig(scheme="int8")
    return {
        "flat": None,
        "hierarchical": base.TopologyConfig(
            kind="hierarchical", groups=2, outer_every=2,
            outer_comm=base.CommConfig(scheme="int8_topk"),
            elastic=base.ElasticConfig(period=4, drop_frac=0.25)),
        "gossip": base.TopologyConfig(kind="gossip",
                                      graph="one_peer_exponential",
                                      inner_comm=comm),
        "async": base.TopologyConfig(kind="async", server=base.AsyncConfig(
            staleness=3, step_time=(1, 1, 2, 4, 1, 1, 2, 4))),
    }


@pytest.mark.parametrize("topology", ["flat", "hierarchical", "gossip",
                                      "async"])
@pytest.mark.parametrize("comm", [None, "int8"])
@pytest.mark.parametrize("per_device", [True, False])
def test_compute_terms_equal_jax_field_for_field(topology, comm, per_device):
    arch = "qwen3-1.7b"
    kw = dict(arch=arch, mesh_name="pod", chips=16, hlo_flops=3.2e15,
              hlo_bytes=4.1e12, collective_bytes=7.5e10, k_steps=4,
              per_device=per_device, num_learners=8)
    want = jterms.compute_terms(
        shape=jbase.INPUT_SHAPES["train_4k"], cfg=jbase.get_config(arch),
        comm=None if comm is None else jbase.CommConfig(scheme=comm),
        topology=_topologies(jbase)[topology], **kw).to_dict()
    got = terms.compute_terms(
        shape=tbase.INPUT_SHAPES["train_4k"], cfg=tbase.get_config(arch),
        comm=None if comm is None else tbase.CommConfig(scheme=comm),
        topology=_topologies(tbase)[topology], rates=JAX_RATES,
        **kw).to_dict()
    assert got == want
    h100 = terms.compute_terms(
        shape=tbase.INPUT_SHAPES["train_4k"], cfg=tbase.get_config(arch),
        comm=None if comm is None else tbase.CommConfig(scheme=comm),
        topology=_topologies(tbase)[topology], **kw)
    div = 1 if per_device else kw["chips"]
    assert h100.compute_s == kw["hlo_flops"] / (div * 989.4e12)
    assert h100.memory_s == kw["hlo_bytes"] / (div * 3.35e12)
    assert h100.wire_bytes == got["wire_bytes"]
    assert h100.wire_s == terms.wire_seconds(
        h100.wire_intra_bytes, h100.wire_inter_bytes, chips=kw["chips"])


def test_h100_rates_are_the_data_sheets():
    r = terms.H100_SXM
    assert (r.hbm_bytes_per_s, r.f32_flops_per_s, r.tf32_flops_per_s,
            r.bf16_flops_per_s) == (3.35e12, 67e12, 494.7e12, 989.4e12)
    assert (r.intra_link_bytes_per_s, r.inter_link_bytes_per_s) == (
        450e9, 50e9)
    assert "data sheet" in r.name
    assert r.flops_per_s("tf32x3") == 494.7e12 / 3
    with pytest.raises(ValueError, match="unknown flop unit"):
        r.flops_per_s("fp8")
    with pytest.raises(ValueError, match="unit"):
        kcost.KernelCost("x", 1.0, 1.0, "fp8")
    c = kcost.KernelCost("x", 3.35e9, 1e9)
    assert terms.kernel_bound(c) == (1e-3, "bytes")
    c = dataclasses.replace(c, flops=989.4e12 * 2e-3, unit="bf16")
    assert terms.kernel_bound(c) == (pytest.approx(2e-3), "operations")
    assert c.matmul_flops == c.flops
    assert dataclasses.replace(c, unit="f32").matmul_flops == 0.0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_declared_costs_give_perf_mds_bound_column():
    """PERF.md section 6's bound column (ms, rounded as written there) from
    each kernel's declared cost on the full Qwen3-1.7B plane."""
    rows = make_pack_spec(api.init_params(
        None, tbase.get_config("qwen3-1.7b"), "meta")).rows
    assert rows == 13_441_992
    w = _meta(rows, 128)
    L, L2 = 4, 2

    def ms(cost):
        return round(terms.kernel_bound(cost)[0] * 1e3, 2)

    assert ms(fm.cost(w, w, w, 0.7, 1.0, L, torch.float32)) == 18.49
    assert ms(sgd.cost(w, w, 0.01)) == 6.16
    assert ms(bm.cost(w, w, w, 0.7, 1.0)) == 10.27
    st2 = _meta(L2, rows, 128)
    assert ms(pu.pack_update_cost(st2, w, st2, st2, 127, 8)) == 22.60
    assert ms(qk.quantize_cost(w, w, 127, 8)) == 4.62
    q = _meta(rows, 128, dtype=torch.int8)
    assert ms(qk.dequantize_cost(q, _meta(rows // 8, 1))) == 2.57
    assert ms(pu.pack_compress_cost(st2, st2, 127, 8)) == 16.44
    assert ms(pu.pack_compress_cost(st2, st2, 127, 8,
                                    with_err=False)) == 12.33
    st4 = _meta(L, rows, 128)
    assert ms(nm.cost(st4, None)) == 16.44
    assert ms(rr.cost(st4, 1)) == 10.27
    for dt, shape, want in ((torch.bfloat16, (8, 512), 0.015),
                            (torch.bfloat16, (4, 4096), 0.278),
                            (torch.float32, (4, 4096), 1.667),
                            (torch.float32, (8, 512), 0.052)):
        B, S = shape
        c = fa.cost(_meta(B, S, 16, 128, dtype=dt),
                    _meta(B, S, 8, 128, dtype=dt),
                    _meta(B, S, 8, 128, dtype=dt), causal=True)
        assert round(terms.kernel_bound(c)[0] * 1e3, 3) == want, (dt, shape)
    c = fa.cost(_meta(1, 16384, 16, 128, dtype=torch.bfloat16),
                _meta(1, 16384, 8, 128, dtype=torch.bfloat16),
                _meta(1, 16384, 8, 128, dtype=torch.bfloat16), causal=True,
                sliding_window=8192)
    assert round(terms.kernel_bound(c)[0] * 1e3, 3) == 0.834
