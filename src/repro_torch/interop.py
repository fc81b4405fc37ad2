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
    return to_tensor(x, device)


def params_from_jax(tree, device="cpu") -> dict:
    """A JAX param tree (nested dicts of numpy arrays) -> dict of tensors
    with the same keys, shapes and dtypes. Also carries batches over."""
    return _tree(tree, device)


def state_from_jax(state, device="cpu") -> MetaState:
    """A JAX ``MetaState`` with numpy leaves -> the port's MetaState.

    Reads the fields by name; a packed state's layout comes from its
    spec's ``layout_dict()``. The flat topology's state is carried, with
    its error-feedback residual (``comm_residual``); ``topo`` must be None.
    """
    if state.topo is not None:
        raise NotImplementedError("only flat-topology states carry over")
    spec = getattr(state, "spec", None)
    return MetaState(
        global_params=_tree(state.global_params, device),
        momentum=_tree(state.momentum, device),
        learners=_tree(state.learners, device),
        local_momentum=_tree(state.local_momentum, device),
        step=int(np.asarray(state.step)),
        comm_residual=_tree(state.comm_residual, device),
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
