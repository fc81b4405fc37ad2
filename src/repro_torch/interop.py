"""Carry weights, batches and meta state across from the JAX package.

Everything here takes and returns numpy arrays (as ``jax.device_get``
gives them) and torch tensors; nothing imports JAX. The parity tests use
it to feed both packages the same numbers, and to read the port's
results back for comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.meta import MetaState
from repro_torch.pack import PackSpec


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy (or array-like) -> a torch copy with the same dtype. bf16
    arrays (ml_dtypes) go through float32, which holds them exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(x, device):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, device) for v in x)
    return to_tensor(x, device)


def params_from_jax(tree, device="cpu") -> dict:
    """A JAX param tree (nested dicts of numpy arrays) -> dict of tensors
    with the same keys, shapes and dtypes. Also carries batches over."""
    return _tree(tree, device)


def cache_from_jax(cache, device="cpu") -> dict:
    """A JAX decode cache with numpy leaves (as ``jax.device_get`` gives
    it) -> the port's, on ``device``: the same keys and nesting, tuples
    kept (the transformer's ``{"k", "v", "pos"}``, Hymba's window, meta,
    conv and SSM entries, xLSTM's ``{"m": 4-tuple, "s": 4-tuple}``), each
    array a tensor of the same shape and dtype (a copy: decode writes the
    port's cache in place), and pos a 0-d int32 tensor."""
    out = {k: _tree(v, device) for k, v in cache.items() if k != "pos"}
    out["pos"] = torch.tensor(int(np.asarray(cache["pos"])),
                              dtype=torch.int32, device=device)
    return out


# the MetaState.topo keys of the hierarchical and gossip topologies, of the
# async server and of the robust norm clip's ring
TOPO_KEYS = frozenset({
    "params", "momentum", "residual", "membership", "group_params",
    "group_momentum", "inner_residual", "outer_residual", "robust_ring",
    "robust_count", "clock", "pull_update", "updates", "anchor",
})
# topo keys the port keeps on the host: the elastic schedule, the ring and
# the async server's clocks
HOST_TOPO_KEYS = frozenset({"membership", "robust_ring", "robust_count",
                            "clock", "pull_update", "updates"})


def state_from_jax(state, device="cpu") -> MetaState:
    """A JAX ``MetaState`` with numpy leaves -> the port's MetaState.

    Reads the fields by name; a packed state's layout comes from its
    spec's ``layout_dict()``. The flat topology's error-feedback residual
    (``comm_residual``) is carried, and so are the hierarchical, gossip and
    async buffers of ``topo`` and the robust clip's ring; the elastic
    ``membership`` schedule, the ring and the async clocks stay on the
    host, where the port's topologies read them.
    """
    topo = state.topo
    if topo is not None:
        unknown = set(topo) - TOPO_KEYS
        if unknown:
            raise ValueError(
                f"topology buffers {sorted(unknown)} are not buffers of "
                f"any topology of the port")
        topo = {k: _tree(v, "cpu" if k in HOST_TOPO_KEYS else device)
                for k, v in topo.items()}
    spec = getattr(state, "spec", None)
    return MetaState(
        global_params=_tree(state.global_params, device),
        momentum=_tree(state.momentum, device),
        learners=_tree(state.learners, device),
        local_momentum=_tree(state.local_momentum, device),
        step=int(np.asarray(state.step)),
        comm_residual=_tree(state.comm_residual, device),
        topo=topo,
        spec=None if spec is None else PackSpec.from_layout(
            spec.layout_dict()),
    )


def dither_from_numpy(fn):
    """A dither source for ``comm.QuantReducer`` from
    ``fn(leaf_index, step, shape) -> numpy array`` of uniforms in [0, 1):
    for example the JAX reducer's own, which a caller that imports JAX
    makes with ``jax.random.uniform(QuantReducer(seed=s)._leaf_key(i,
    step), shape)``. Each call returns a new float32 tensor on the
    requested device, which the reducer may write over."""

    def dither(leaf_index, step, shape, device):
        a = np.array(fn(int(leaf_index), int(step), tuple(shape)),
                     dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"dither of shape {a.shape}, expected "
                             f"{tuple(shape)}")
        return torch.from_numpy(a).to(device)

    return dither
