"""The per-run manifest: everything needed to interpret a run log (the JAX
package's ``obs/manifest.py``).

One JSON-able dict, written as the first record of every sink stream
(sink.py) and beside checkpoints (``checkpoint/npz.py``): the full config,
the packed meta-plane layout hash (a resume against another layout is
another run), the topology / reducer / elastic settings that decide which
metric columns exist, and the device environment.

The environment keys follow ``tools/telemetry_schema.json``, which asks
every manifest for ``jax_version``, ``backend``, ``device_count``,
``devices`` and ``process_index``. The port runs no JAX, so
``jax_version`` is null; ``torch_version`` and ``cuda_version`` say what
it runs instead, ``backend`` is the torch device type (``"cuda"`` or
``"cpu"``) and ``devices`` the card names. The compiled-program cost that
JAX can add (``jit_cost``, from XLA's cost analysis) has no counterpart in
the port yet (ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import time

import torch

# history (as in the JAX package): 1 = manifest/step/row kinds; 2 = the
# ``alert`` and ``attribution`` kinds; 3 = the supervisor's ``fault`` and
# ``recovery`` kinds and the optional ``nonfinite_learners`` step metric;
# 4 = the ``robust`` kind. Each addition is additive; the checker gates on
# the major
SCHEMA_VERSION = 4


def packspec_hash(spec) -> str | None:
    """Short stable hash of the packed meta-plane layout (``PackSpec``):
    the identity of the flat-buffer encoding, equal to the JAX package's
    for the same layout."""
    if spec is None:
        return None
    blob = json.dumps(spec.layout_dict(), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def device_env(device=None) -> dict:
    """The environment keys of a manifest for ``device`` (default: the card
    when one is visible, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        devs = [torch.cuda.get_device_name(i) for i in range(min(n, 8))]
        if n > 8:
            devs.append(f"... {n - 8} more")
    else:
        n, devs = 1, [platform.processor() or platform.machine() or "cpu"]
    return {
        "jax_version": None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_count": n,
        "devices": devs,
        "process_index": 0,
    }


def run_manifest(*, train_cfg=None, mcfg=None, spec=None, suite=None,
                 device=None, extra=None) -> dict:
    """Build the manifest dict.

    ``train_cfg``: TrainConfig (trainer runs; carries the MAvgConfig);
    ``mcfg``: a bare MAvgConfig (runs without a Trainer); ``suite``: a
    bench suite name; ``device``: the run's device; ``extra``: free-form
    additions, merged last.
    """
    man = {
        "schema_version": SCHEMA_VERSION,
        "created_unix": time.time(),
        **device_env(device),
    }
    if suite is not None:
        man["suite"] = str(suite)
    m = train_cfg.mavg if train_cfg is not None else mcfg
    if m is not None:
        man.update(
            algorithm=m.algorithm,
            num_learners=m.num_learners,
            k_steps=m.k_steps,
            topology=m.topology.kind,
            comm_scheme=m.comm.scheme,
            elastic=m.topology.elastic is not None,
            packed=m.packed,
            donate=m.donate,
        )
    if train_cfg is not None:
        man["config"] = dataclasses.asdict(train_cfg)
    elif mcfg is not None:
        man["config"] = dataclasses.asdict(mcfg)
    h = packspec_hash(spec)
    if h is not None:
        man["packspec_hash"] = h
    if extra:
        man.update(extra)
    return man
