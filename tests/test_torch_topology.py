"""The port's gossip topology and its kernels (``repro_torch.topology``,
``kernels/neighbor_mix.py``, ``pack_compress``) against the JAX package's.

Both sides get the same numpy inputs, and the quantizers JAX's own
dither (``interop.dither_from_numpy``). Tolerances, with their reasons:

* mixing matrices, periods and degrees: EXACTLY equal (the same numpy
  code);
* spectral gaps: within 1e-5 (two f32 eigensolvers);
* ``neighbor_mix``: the plain version sums W_jk x_k in order k = 0..L-1,
  one rounding per product and per sum; JAX contracts the same sum as a
  matrix product in its own order, so rtol 1e-6 (atol 1e-6 for values
  that cancel), in f32 and, after the bf16 cast, within one bf16 ulp;
* ``pack_compress``: the plain version equals JAX's ``ref.pack_compress_ref``
  bitwise; against the Pallas kernel in interpret mode the rounding
  decisions q are identical and c/err agree within ``PACK_ULPS`` ulps of
  their chunk's max |d| (XLA divides by qmax through a reciprocal and
  contracts d - q s, tests/test_torch_kernels.py);
* gossip meta steps on the MLP, 3 steps: rtol 1e-5 / atol 1e-6 (the local
  phase differs by a few ulps between XLA:CPU and ATen). A compressed run
  may flip a stochastic-rounding decision where a displacement moved by
  an ulp, which moves that value by one scale quantum (x_j by up to
  (1 + mu) quanta through the mix and the momentum, the residual by one):
  such runs agree except at a share ``FLIP_SHARE`` of the values, each
  within ``FLIP_QUANTA`` quanta of the largest scale. The mix sums in
  another order than JAX's product only where a weight is inexact (the
  ring's 1/3 at L=4), and a flip there moves the coordinate of every
  graph neighbour and their next displacements: ring int8 + EF flipped
  0.54 % of the packed residual (0.41 quanta at most), every other case
  nothing, so the share is twice the flat path's
  (tests/test_torch_comm.py).

The in-port invariants of tests/test_topology.py (T1-T3) are pinned on
the port alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import QuantReducer as JQuantReducer  # noqa: E402
from repro.configs.base import CommConfig as JCommConfig  # noqa: E402
from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.configs.base import TopologyConfig as JTopologyConfig  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.kernels import neighbor_mix as jnm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack_update as jpu  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.topology import gossip as jgossip  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    GOSSIP_GRAPHS,
    CommConfig,
    MAvgConfig,
    TopologyConfig,
)
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import neighbor_mix as nm  # noqa: E402
from repro_torch.kernels import pack_update as pu  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.topology import gossip, make_topology  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))
FLIP_SHARE = 1e-2
FLIP_QUANTA = 2.0
PACK_ULPS = 2.25
COMMS = {
    "dense": dict(scheme="dense"),
    "int8": dict(scheme="int8", error_feedback=False),
    "int8_ef": dict(scheme="int8", error_feedback=True),
}


def _jax_dither(seed=0):
    red = JQuantReducer(seed=seed)
    return interop.dither_from_numpy(
        lambda i, step, shape: np.asarray(
            jax.random.uniform(red._leaf_key(i, step), shape, jnp.float32)))


def _batches(seed, L, K, B=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((L, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (L, K, B)).astype(np.int32)}


def _cfgs(kw, topo, comm=None):
    """The same MAvgConfig for JAX and for the port."""
    def make(M, T, Cm):
        t = dict(topo)
        if comm is not None:
            t["inner_comm"] = Cm(**comm)
        return M(**kw, topology=T(**t))

    return (make(JMAvgConfig, JTopologyConfig, JCommConfig),
            make(MAvgConfig, TopologyConfig, CommConfig))


def _run_jax(jcfg, batch_list):
    state = jinit_state(JPARAMS, jcfg)
    step = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    metrics = []
    for b in batch_list:
        state, m = step(state, b)
        metrics.append(m)
    return jax.device_get(state), metrics


def _spy_quantum(reducer):
    """Record the largest scale quantum, max |delta (+ e)| / 127, of every
    compress call of the quantizer inside ``reducer``. Returns the dict
    that holds it."""
    seen = {"quantum": 0.0}
    q = getattr(reducer, "inner", reducer)
    for name in ("_compress_packed", "_compress"):
        if not hasattr(q, name):  # the dense reducer compresses nothing
            continue

        def wrapped(delta, step, *a, _orig=getattr(q, name), **k):
            big = max(float(x.abs().max()) for x in tree_leaves(delta))
            seen["quantum"] = max(seen["quantum"], big / 127)
            return _orig(delta, step, *a, **k)

        setattr(q, name, wrapped)
    return seen


def _run_port(cfg, batch_list):
    """Returns (state, metrics per step, largest scale quantum)."""
    topology = make_topology(cfg, dither=_jax_dither())
    seen = _spy_quantum(getattr(topology, "reducer",
                                getattr(topology, "inner_reducer", None)))
    state = init_state(interop.params_from_jax(JPARAMS), cfg,
                       topology=topology)
    step = make_meta_step(mlp_loss, cfg, topology=topology)
    metrics = []
    for b in batch_list:
        state, m = step(state, interop.params_from_jax(b))
        metrics.append(m)
    return state, metrics, seen["quantum"]


def _close_or_flipped(got, want, quantum):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert off.mean() <= FLIP_SHARE, off.mean()
    assert np.all(np.abs(got - want)[off] <= FLIP_QUANTA * quantum)


def _compare_states(state, jstate, quantum=0.0, keys=None):
    pairs = [(state.global_params, jstate.global_params),
             (state.learners, jstate.learners)]
    for k in keys or [k for k, v in jstate.topo.items() if v is not None]:
        pairs.append((state.topo[k], jstate.topo[k]))
    for port, ref in pairs:
        pl, rl = tree_leaves(port), jax.tree.leaves(ref)
        assert len(pl) == len(rl)
        for a, b in zip(pl, rl):
            if quantum:
                _close_or_flipped(a, b, quantum)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)


def _compare_metrics(metrics, jmetrics, names, rtol=1e-5):
    for m, jm in zip(metrics, jmetrics):
        for k in names:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# mixing matrices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", GOSSIP_GRAPHS)
@pytest.mark.parametrize("L", [1, 2, 3, 4, 7, 8, 16])
def test_mixing_matrices_match_jax(graph, L):
    T = gossip.mixing_period(graph, L)
    assert T == jgossip.mixing_period(graph, L)
    for t in range(T + 1):
        np.testing.assert_array_equal(gossip.mixing_matrix(graph, L, t),
                                      jgossip.mixing_matrix(graph, L, t))
        assert (gossip.graph_degree(graph, L, t)
                == jgossip.graph_degree(graph, L, t))
    np.testing.assert_array_equal(gossip.mixing_matrix_stack(graph, L),
                                  jgossip.mixing_matrix_stack(graph, L))
    assert (gossip.avg_graph_degree(graph, L)
            == jgossip.avg_graph_degree(graph, L))
    W = gossip.mixing_matrix(graph, L)  # T3: doubly stochastic, symmetric
    np.testing.assert_allclose(W.sum(0), 1.0, rtol=1e-6)
    np.testing.assert_allclose(W.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(W, W.T)


@pytest.mark.parametrize("graph", GOSSIP_GRAPHS)
def test_spectral_gap_matches_jax(graph):
    from repro.topology.elastic import mask_mixing_matrix as jmask

    from repro_torch.topology.elastic import mask_mixing_matrix

    L = 8
    for t in range(gossip.mixing_period(graph, L)):
        W = gossip.mixing_matrix(graph, L, t)
        np.testing.assert_allclose(gossip.spectral_gap(W),
                                   float(jgossip.spectral_gap(W)), atol=1e-5)
    m = np.ones(L, np.float32)
    m[[1, 6]] = 0.0
    W = gossip.mixing_matrix(graph, L)
    got = gossip.spectral_gap(mask_mixing_matrix(W, m), m)
    want = jgossip.spectral_gap(jmask(jnp.asarray(W), jnp.asarray(m)), m)
    np.testing.assert_allclose(got, float(want), atol=1e-5)
    assert gossip.spectral_gap(np.ones((1, 1), np.float32)) == 1.0


# ---------------------------------------------------------------------------
# neighbor_mix
# ---------------------------------------------------------------------------


def _stack(seed, L, rows):
    return np.random.default_rng(seed).standard_normal(
        (L, rows, 128)).astype(np.float32)


@pytest.mark.parametrize("L,rows", [(2, 8), (4, 64), (8, 256), (3, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbor_mix_matches_jax_kernel(L, rows, dtype):
    x = _stack(L * rows, L, rows)
    W = gossip.mixing_matrix("exponential", L)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = ops.neighbor_mix(tx, W)
    want = np.asarray(jnm.neighbor_mix_3d(jx, jnp.asarray(W),
                                          interpret=True), np.float32)
    assert got.dtype == tx.dtype and tuple(got.shape) == x.shape
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:  # one bf16 ulp where the f32 sums round to either side
        assert np.all(np.abs(got - want)
                      <= np.spacing(np.abs(want)) * 2 ** 16 + 1e-6)
    # the stepped entry picks stack[step % T]
    stack = gossip.mixing_matrix_stack("one_peer_exponential", L)
    for t in (0, 1, 5):
        got = ops.neighbor_mix(tx, stack, step=t).to(torch.float32).numpy()
        want = np.asarray(jnm.neighbor_mix_3d_stepped(
            jx, jnp.asarray(stack), t, interpret=True), np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-2
                                   if dtype == "bfloat16" else 1e-6)


def test_neighbor_mix_plain_order_and_in_place():
    """acc = 0; acc += W_jk x_k in order: bitwise what a float32 loop in
    numpy gives; in place equals out of place; zero weights multiply, so
    an Inf spreads to every learner as through a dense product."""
    L, rows = 4, 16
    x = _stack(5, L, rows)
    W = np.random.default_rng(6).random((L, L)).astype(np.float32)
    want = np.zeros_like(x)
    for j in range(L):
        for k in range(L):
            want[j] = want[j] + W[j, k] * x[k]
    tx = torch.from_numpy(x.copy())
    fresh = ops.neighbor_mix(tx, W)
    np.testing.assert_array_equal(fresh.numpy(), want)
    out = ops.neighbor_mix(tx, W, out=tx)
    assert out is tx and torch.equal(tx, fresh)
    x[2, 0, 0] = np.inf
    got = ops.neighbor_mix(torch.from_numpy(x), np.eye(L, dtype=np.float32))
    assert torch.isnan(got[:, 0, 0]).sum() == L - 1  # 0 * inf = nan


@pytest.mark.parametrize("shape", [(1000,), (33, 7), (3,)])
def test_neighbor_mix_any_shape_matches_jax(shape):
    L = 4
    x = np.random.default_rng(7).standard_normal((L,) + shape).astype(
        np.float32)
    W = gossip.mixing_matrix("exponential", L)
    got = ops.neighbor_mix(torch.from_numpy(x), W)
    want = jops.neighbor_mix(jnp.asarray(x), jnp.asarray(W), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    stack = gossip.mixing_matrix_stack("one_peer_exponential", L)
    tree = ops.neighbor_mix_tree({"y": torch.from_numpy(x)}, stack, step=3)
    np.testing.assert_allclose(
        tree["y"].numpy(),
        np.asarray(jref.neighbor_mix_stepped_ref(jnp.asarray(x),
                                                 jnp.asarray(stack), 3)),
        rtol=1e-6, atol=1e-6)


def test_neighbor_mix_refusals():
    x = torch.zeros(2, 8, 128)
    stack = gossip.mixing_matrix_stack("one_peer_exponential", 4)
    with pytest.raises(ValueError, match="step"):
        ops.neighbor_mix(torch.zeros(4, 8, 128), stack)
    with pytest.raises(ValueError, match="shape"):
        ops.neighbor_mix(x, np.eye(3, dtype=np.float32))
    # the CUDA wrappers take CUDA tensors only, and at most 16 learners
    with pytest.raises(ValueError, match="CUDA tensor"):
        nm.neighbor_mix_cuda(x, np.eye(2, dtype=np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        nm.neighbor_mix_stepped_cuda(torch.zeros(4, 8, 128), stack, 1)
    with pytest.raises(ValueError, match="1 to 16"):
        nm.neighbor_mix_cuda(torch.zeros(17, 8, 128),
                             np.eye(17, dtype=np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pu.pack_compress_cuda(x, x, 127, 8)
    meta = torch.empty((2, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.neighbor_mix(meta, np.eye(2, dtype=np.float32))
    with pytest.raises(ValueError, match="no kernel"):
        ops.pack_compress(meta, meta)


# ---------------------------------------------------------------------------
# pack_compress
# ---------------------------------------------------------------------------


def _chunk_ulps(x, block):
    lead = x.shape[:-2]
    xb = np.abs(x).reshape(lead + (-1, block * 128))
    amax = xb.max(axis=-1, keepdims=True)
    return np.broadcast_to(np.spacing(amax), xb.shape).reshape(x.shape)


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("with_err", [True, False], ids=["err", "no_err"])
def test_pack_compress_matches_jax(block, with_err):
    d = _stack(20, 3, 192) * np.float32(0.05)
    u = np.random.default_rng(21).random(d.shape, dtype=np.float32)
    got = ops.pack_compress(torch.from_numpy(d), torch.from_numpy(u),
                            block=block, with_err=with_err)
    want = jref.pack_compress_ref(jnp.asarray(d), jnp.asarray(u), 127, block,
                                  with_err=with_err)
    assert (got[1] is None) == (not with_err)
    for a, b in zip(got, want):  # the oracle: bitwise
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c, err, scales = jpu.pack_compress_3d(
        jnp.asarray(d), jnp.asarray(u), block=block, with_err=with_err,
        interpret=True)
    c, scales = np.asarray(c), np.asarray(scales)
    rep = lambda s: np.repeat(s, block * 128, axis=1).reshape(d.shape)  # noqa
    np.testing.assert_array_equal(np.rint(got[0].numpy() / rep(got[2].numpy())),
                                  np.rint(c / rep(scales)))
    ulps = _chunk_ulps(d, block)
    assert np.all(np.abs(got[0].numpy() - c) <= PACK_ULPS * ulps)
    if with_err:
        assert np.all(np.abs(got[1].numpy() - np.asarray(err))
                      <= PACK_ULPS * ulps)


@pytest.mark.parametrize("with_err", [True, False], ids=["err", "no_err"])
def test_pack_compress_is_pack_update_with_zero_gp(with_err):
    """Bitwise, and in place (c over u, err over d) as the gossip step
    runs it."""
    d = _stack(22, 2, 64) * np.float32(0.05)
    u = np.random.default_rng(23).random(d.shape, dtype=np.float32)
    c0, e0, s0 = ops.pack_update(torch.from_numpy(d), torch.zeros(64, 128),
                                 None, torch.from_numpy(u), block=8)
    td, tu = torch.from_numpy(d.copy()), torch.from_numpy(u.copy())
    c, err, s = ops.pack_compress(td, tu, block=8, with_err=with_err,
                                  c_out=tu, err_out=td if with_err else None)
    assert c is tu and torch.equal(c, c0) and torch.equal(s, s0)
    if with_err:
        assert err is td and torch.equal(err, e0)
    else:
        assert err is None and np.array_equal(td.numpy(), d)
    before = pu.COMPRESS_LAUNCHES
    ops.pack_compress(td, tu)
    assert pu.COMPRESS_LAUNCHES == before  # the plain version is no launch


def test_block_momentum_updates_a_stack_in_place():
    """(L, rows, 128) stacks: in place, bitwise the per-plane update."""
    rng = np.random.default_rng(24)
    w, v, a = (torch.from_numpy(rng.standard_normal((3, 16, 128))
                                .astype(np.float32)) for _ in range(3))
    want = [ops.block_momentum(w[j].clone(), v[j].clone(), a[j], mu=0.6,
                               eta=1.3) for j in range(3)]
    gw, gv = ops.block_momentum(w, v, a, mu=0.6, eta=1.3)
    assert gw is w and gv is v
    for j in range(3):
        assert torch.equal(w[j], want[j][0]) and torch.equal(v[j], want[j][1])


# ---------------------------------------------------------------------------
# gossip meta steps against JAX
# ---------------------------------------------------------------------------

GOSSIP_METRICS = ("loss", "grad_norm", "loss_spread", "v_norm",
                  "displacement_norm", "consensus_dist",
                  "mixing_spectral_gap", "comm_bytes", "comm_bytes_dense",
                  "comm_compression")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
@pytest.mark.parametrize("comm", list(COMMS))
@pytest.mark.parametrize("graph", GOSSIP_GRAPHS)
def test_gossip_matches_jax(graph, comm, packed):
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.6, packed=packed)
    topo = dict(kind="gossip", graph=graph, momentum_tracking=True)
    jcfg, cfg = _cfgs(kw, topo, COMMS[comm])
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    jstate, jm = _run_jax(jcfg, batch_list)
    state, m, quantum = _run_port(cfg, batch_list)
    assert state.step == 3 and (quantum > 0) == (comm != "dense")
    _compare_states(state, jstate, quantum=quantum)
    # the norms of a compressed run move with its flipped roundings
    names = GOSSIP_METRICS if comm == "dense" else (
        "loss", "mixing_spectral_gap", "comm_bytes", "comm_bytes_dense",
        "comm_compression")
    _compare_metrics(m, jm, names)


def test_gossip_stepped_graph_goes_through_the_stepped_entry(monkeypatch):
    """one_peer_exponential mixes through ``neighbor_mix`` with the (T, L, L)
    stack and the step (the stepped kernel entry on the card), twice per
    step under momentum tracking; a static graph passes its matrix."""
    calls = []
    real = ops.neighbor_mix

    def spy(x, w, *, step=None, out=None):
        calls.append((w.ndim, step))
        return real(x, w, step=step, out=out)

    monkeypatch.setattr(ops, "neighbor_mix", spy)
    for graph, want in (("one_peer_exponential", [(3, 0), (3, 0), (3, 1),
                                                  (3, 1)]),
                        ("ring", [(2, None)] * 4)):
        calls.clear()
        _, cfg = _cfgs(dict(num_learners=4, k_steps=1),
                       dict(kind="gossip", graph=graph,
                            momentum_tracking=True))
        _run_port(cfg, [_batches(s, 4, 1) for s in range(2)])
        assert calls == want, (graph, calls)


# ---------------------------------------------------------------------------
# invariants T2-T3 (tests/test_topology.py), inside the port
# ---------------------------------------------------------------------------


def test_t2_gossip_complete_is_kavg():
    base = dict(algorithm="kavg", num_learners=4, k_steps=2, learner_lr=0.1)
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    s_kavg, _, _ = _run_port(MAvgConfig(**base), batch_list)
    s_g, _, _ = _run_port(MAvgConfig(**base, topology=TopologyConfig(
        kind="gossip", graph="complete")), batch_list)
    np.testing.assert_allclose(s_g.global_params.numpy(),
                               s_kavg.global_params.numpy(), rtol=1e-5,
                               atol=1e-5)
    # every learner's private params coincide with the global average
    for x in s_g.topo["params"]:
        np.testing.assert_allclose(x.numpy(), s_g.global_params.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_t2_gossip_complete_mu_matches_flat_mavg():
    base = dict(algorithm="mavg", num_learners=4, k_steps=2,
                learner_lr=0.1, momentum=0.6)
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    s_flat, _, _ = _run_port(MAvgConfig(**base), batch_list)
    s_g, _, _ = _run_port(MAvgConfig(**base, topology=TopologyConfig(
        kind="gossip", graph="complete")), batch_list)
    np.testing.assert_allclose(s_g.global_params.numpy(),
                               s_flat.global_params.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("graph", GOSSIP_GRAPHS)
def test_t3_gossip_preserves_the_learner_mean(graph):
    L = 8
    x = {"a": torch.randn(L, 5, 7, generator=torch.Generator()
                          .manual_seed(11)),
         "b": torch.randn(L, 33, generator=torch.Generator().manual_seed(12))}
    mixed = ops.neighbor_mix_tree(x, gossip.mixing_matrix(graph, L))
    for k in x:
        np.testing.assert_allclose(mixed[k].mean(0).numpy(),
                                   x[k].mean(0).numpy(), rtol=1e-5,
                                   atol=1e-6)
    cfg = MAvgConfig(algorithm="mavg", num_learners=4, k_steps=2,
                     momentum=0.5,
                     topology=TopologyConfig(kind="gossip", graph=graph))
    s, _, _ = _run_port(cfg, [_batches(i, 4, 2) for i in range(3)])
    np.testing.assert_allclose(s.global_params.numpy(),
                               s.topo["params"].mean(0).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_state_from_jax_carries_the_gossip_buffers(packed):
    """A JAX gossip int8 + EF state crosses over with its per-learner
    params, momentum and residual, bitwise, and steps on as in JAX."""
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.6, packed=packed)
    jcfg, cfg = _cfgs(kw, dict(kind="gossip", graph="exponential",
                               momentum_tracking=True), COMMS["int8_ef"])
    jstate, _ = _run_jax(jcfg, [_batches(40, 4, 2)])
    carried = interop.state_from_jax(jstate)
    assert carried.step == 1 and set(carried.topo) == set(jstate.topo)
    for k, v in jstate.topo.items():
        for a, b in zip(tree_leaves(carried.topo[k]), jax.tree.leaves(v)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    b1 = _batches(41, 4, 2)
    jstep = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    ref = jax.device_get(jstep(jax.tree.map(jnp.asarray, jstate), b1)[0])
    topology = make_topology(cfg, dither=_jax_dither())
    state, _ = make_meta_step(mlp_loss, cfg, topology=topology)(
        carried, interop.params_from_jax(b1))
    _compare_states(state, ref)


def test_state_from_jax_refuses_unported_buffers():
    """Every topology's buffers are carried now (the async server's clocks
    to the host); a key no topology of the port has (the retired downpour
    queue) is refused."""
    class Fake:
        topo = {"stale_queue": np.zeros(4)}

    with pytest.raises(ValueError, match="stale_queue"):
        interop.state_from_jax(Fake())
    assert "clock" in interop.HOST_TOPO_KEYS
    assert {"clock", "pull_update", "updates", "anchor"} <= interop.TOPO_KEYS
