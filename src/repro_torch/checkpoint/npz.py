"""Flat-npz checkpointer of the port, in the JAX package's file format
(``checkpoint/npz.py`` there): each package loads the other's snapshots.

The format, entry for entry:

  * one entry per leaf of the ``MetaState``, keyed by its slash-joined
    path: the fields in JAX's flatten order (``global_params``,
    ``momentum``, ``learners``, ``local_momentum``, ``step``,
    ``comm_residual``, ``topo``), dict keys in sorted order, topology
    buffers under ``topo/<key>/...``, and no entry for a field or dict
    value that is None;
  * a packed state (``MetaState.spec`` set) saves each plane as its single
    (rows, 128) / (lead, rows, 128) buffer under the plain field key, plus
    a ``__packspec__`` entry holding the JSON of ``spec.layout_dict()``;
  * ``step`` is a 0-d int32 array (a Python int in the port's state);
  * planes keep their dtypes. bfloat16 has no numpy dtype without
    ``ml_dtypes``, which the port does not import: a bf16 plane is written
    and read as raw 16-bit words (``torch.int16`` views), which is the
    ``|V2`` array a JAX bf16 plane becomes in an ``.npz`` (JAX's header
    spells it ``<V2``, the port's ``|V2``; numpy reads both as ``|V2``,
    and the bytes and CRCs are the same);
  * beside each ``step_<n>.npz`` a ``.crc32.json`` sidecar records the
    npz's byte size and, per entry, the CRC32 of its bytes, its shape and
    its dtype name (``"bfloat16"`` for a bf16 plane, as JAX writes it).

Loading is layout-converting in the legacy direction, as in JAX: a
per-leaf checkpoint restores into a packed template by packing each
plane's ``<field>/<leaf path>`` entries through the template's spec.

Where the port departs from JAX:

  * ``load_state`` restores IN PLACE: it copies each entry into the
    template state's existing planes (``Tensor.copy_``) and returns the
    template with its ``step`` set; it allocates no second state. The
    full-depth flat L=4 state of Qwen3-1.7B is 41.3 GB, and two of them do
    not fit one card. JAX's functional load returns a new state. Every
    entry's presence and shape is checked before the first copy, so a
    refused checkpoint leaves the template untouched.
  * ``manifest.json`` is written when ``save_state`` is given a manifest
    (the Trainer passes its ``repro_torch.obs`` run manifest, as in JAX);
    the loader ignores it in either package's directory (it is not part
    of the snapshot).
  * The npz is serialised in memory as in JAX, but written from the
    buffer without copying it again, so the host holds about twice the
    state rather than three times.

Host topology keys (``membership``, ``robust_ring``, ``robust_count`` and
the async server's int32 ``clock``, ``pull_update`` and ``updates``) live
on the CPU in the port's state and are restored there; the async
``anchor`` stack is a plane on the state's device.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import zlib

import numpy as np
import torch

from repro_torch.core.meta import MetaState
from repro_torch.utils.retry import retry_io

PACKSPEC_KEY = "__packspec__"

# per-snapshot integrity sidecar: ``step_<n>.npz.crc32.json`` records the
# byte size of the npz and a CRC32 + shape/dtype per entry, written
# atomically AFTER the npz itself; a snapshot without a (matching) sidecar
# is by definition unverified (torn mid-save)
CRC_SUFFIX = ".crc32.json"

# MetaState's data fields in the order JAX flattens its registered
# dataclass (``spec`` is static there and not a leaf)
STATE_FIELDS = ("global_params", "momentum", "learners", "local_momentum",
                "step", "comm_residual", "topo")


class CheckpointVerifyError(RuntimeError):
    """A snapshot failed integrity verification (torn write, bit rot,
    entry-set mismatch or, with ``check_finite``, a poisoned state).
    ``latest_verified_checkpoint`` skips such snapshots."""


def _entries(tree, prefix: str = "") -> list:
    """(key, leaf) of every leaf of a MetaState or a nested dict, in JAX's
    flatten order; None values contribute nothing."""
    if isinstance(tree, MetaState):
        return [e for f in STATE_FIELDS
                for e in _entries(getattr(tree, f), f"{prefix}{f}/")]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _entries(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _host(key: str, leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and the dtype name the sidecar
    records. The port's int ``step`` becomes JAX's 0-d int32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2"), "bfloat16"
        arr = t.cpu().numpy()
    elif key == "step" and isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _atomic_write(path: str, data) -> None:
    """tmp + flush + fsync + rename: a reader never observes a partial
    file at ``path``; transient OSErrors get the bounded retry."""

    def write():
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    retry_io(write)


def _entry_crc(arr: np.ndarray) -> int:
    """CRC32 of the entry's bytes in C order (read in place, not copied)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save_state(directory: str, state, step: int, manifest=None, *,
               keep: int = 0, fault=None) -> str:
    """Snapshot ``state`` (a MetaState or a nested dict of tensors or
    arrays) to ``directory/step_<step>.npz``, atomically and with a CRC32
    integrity sidecar.

    The write order is the crash-safety contract: (1) the whole npz is
    serialised in memory and landed via tmp + fsync + rename, (2) the
    sidecar lands the same way, (3) ``manifest.json`` is rewritten, also
    atomically, when a ``manifest`` dict is given. A crash between any two
    leaves either no new snapshot or an npz without a sidecar, both of
    which ``latest_verified_checkpoint`` skips.

    ``keep``: after a successful save, prune snapshots older than the
    ``keep`` newest sidecar-complete ones (0 keeps everything).

    ``fault``: the chaos hook (``repro_torch.chaos``; tests and benches
    only). ``"torn"`` writes half the npz at the final path with no
    sidecar; ``"corrupt"`` completes the save and then flips one byte of
    the npz in place, which the CRC catches. None is the only production
    value.

    Host-sync discipline: one ``torch.cuda.synchronize`` up front when any
    leaf lies on the card, then plain device-to-host copies of finished
    buffers. Pass the state a step returned: the meta step consumes its
    input state.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    entries = _entries(state)
    if any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in entries):
        torch.cuda.synchronize()
    flat, dtypes = {}, {}
    for key, leaf in entries:
        flat[key], dtypes[key] = _host(key, leaf)
    spec = getattr(state, "spec", None)
    if spec is not None:
        flat[PACKSPEC_KEY] = np.asarray(json.dumps(spec.layout_dict()))
        dtypes[PACKSPEC_KEY] = str(flat[PACKSPEC_KEY].dtype)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    data = buf.getbuffer()
    if fault == "torn":
        # a simulated mid-save crash: half the bytes at the FINAL path and
        # no sidecar, what a non-atomic np.savez leaves behind
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
        return path
    sidecar = {
        "step": int(step),
        "npz_bytes": len(data),
        "entries": {
            k: {"crc32": _entry_crc(v), "shape": list(np.shape(v)),
                "dtype": dtypes[k]}
            for k, v in flat.items()
        },
    }
    _atomic_write(path, data)
    del data, buf, flat
    _atomic_write(path + CRC_SUFFIX,
                  json.dumps(sidecar, sort_keys=True).encode())
    if fault == "corrupt":
        size = sidecar["npz_bytes"]
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0x10]))
    if manifest is not None:
        _atomic_write(
            os.path.join(directory, "manifest.json"),
            json.dumps(manifest, indent=2, sort_keys=True,
                       default=str).encode(),
        )
    if keep:
        prune_checkpoints(directory, keep)
    return path


def _sidecar_ok(path: str) -> bool:
    """Cheap verification without reading the npz: the sidecar exists,
    parses and records the npz's actual byte size. Retention uses it;
    resume uses the full ``verify_checkpoint``."""
    try:
        with open(path + CRC_SUFFIX) as f:
            sc = json.load(f)
        return sc.get("npz_bytes") == os.path.getsize(path)
    except (OSError, ValueError):
        return False


def _snapshots(directory: str) -> list[str]:
    return sorted(f for f in os.listdir(directory)
                  if f.endswith(".npz") and not f.endswith(".npz.tmp"))


def prune_checkpoints(directory: str, keep: int) -> list[str]:
    """Delete snapshots older than the ``keep`` newest sidecar-complete
    ones (their sidecars too, and older torn leftovers). Returns the
    removed npz paths.

    Removal order is sidecar first, npz second: an interrupted pair leaves
    an npz with no sidecar, which rollback skips and the next prune
    sweeps, never an orphaned sidecar. Sidecars whose snapshot is already
    gone are swept too.
    """
    assert keep >= 1, keep
    if not os.path.isdir(directory):
        return []
    names = os.listdir(directory)
    snaps = _snapshots(directory)
    removed = []
    for f in names:
        if f.endswith(CRC_SUFFIX) and f[: -len(CRC_SUFFIX)] not in snaps:
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass
    verified = [f for f in snaps if _sidecar_ok(os.path.join(directory, f))]
    if len(verified) <= keep:
        return []
    cutoff = verified[-keep]
    for f in snaps:
        if f >= cutoff:
            continue
        p = os.path.join(directory, f)
        try:
            if os.path.exists(p + CRC_SUFFIX):
                os.remove(p + CRC_SUFFIX)
            os.remove(p)
            removed.append(p)
        except OSError:
            pass  # retention is best-effort; verify guards correctness
    return removed


def verify_checkpoint(path: str, *, check_finite: bool = True) -> None:
    """Raise ``CheckpointVerifyError`` unless ``path`` is a complete,
    uncorrupted snapshot: sidecar present and parseable, npz size and
    entry set match it, every entry's CRC32 matches, and (with
    ``check_finite``) no float entry carries NaN/Inf. Entries numpy
    cannot test for finiteness (bf16 planes, read as ``|V2``; strings)
    count as finite, as in JAX."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise CheckpointVerifyError(f"{path}: unreadable ({e})")
    try:
        with open(path + CRC_SUFFIX) as f:
            sidecar = json.load(f)
    except OSError:
        raise CheckpointVerifyError(
            f"{path}: no {CRC_SUFFIX} sidecar (save died before the "
            f"sidecar landed, or a pre-integrity-chain snapshot)")
    except ValueError as e:
        raise CheckpointVerifyError(f"{path}: torn sidecar ({e})")
    entries = sidecar.get("entries")
    if not isinstance(entries, dict):
        raise CheckpointVerifyError(f"{path}: sidecar has no entry table")
    if sidecar.get("npz_bytes") != size:
        raise CheckpointVerifyError(
            f"{path}: size {size} != sidecar npz_bytes "
            f"{sidecar.get('npz_bytes')} (torn write)")
    try:
        with np.load(path) as data:
            keys, want = set(data.files), set(entries)
            if keys != want:
                raise CheckpointVerifyError(
                    f"{path}: entry set mismatch vs sidecar (missing "
                    f"{sorted(want - keys)[:4]}, extra "
                    f"{sorted(keys - want)[:4]})")
            for k, meta in entries.items():
                arr = np.asarray(data[k])
                if _entry_crc(arr) != meta.get("crc32"):
                    raise CheckpointVerifyError(
                        f"{path}: CRC32 mismatch on entry {k!r} (bit rot "
                        f"or in-place corruption)")
                if check_finite:
                    try:
                        finite = bool(np.isfinite(arr).all())
                    except TypeError:
                        finite = True
                    if not finite:
                        raise CheckpointVerifyError(
                            f"{path}: non-finite values in entry {k!r}; a "
                            f"poisoned snapshot is not a rollback target")
    except CheckpointVerifyError:
        raise
    except Exception as e:  # zip/zlib/numpy errors on a damaged archive
        raise CheckpointVerifyError(f"{path}: unreadable npz ({e})")


def checkpoint_step(path: str) -> int:
    """Step encoded in a ``step_<n>.npz`` checkpoint filename."""
    name = os.path.basename(path)
    assert name.startswith("step_") and name.endswith(".npz"), path
    return int(name[len("step_"): -len(".npz")])


def verified_checkpoints(directory: str, *, before_step=None,
                         check_finite: bool = True) -> list[str]:
    """Ascending list of the snapshots in ``directory`` that pass
    ``verify_checkpoint``; ``before_step`` keeps only those whose encoded
    step is strictly below it (a rollback target must predate the
    fault)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in _snapshots(directory):
        path = os.path.join(directory, f)
        if before_step is not None and checkpoint_step(path) >= before_step:
            continue
        try:
            verify_checkpoint(path, check_finite=check_finite)
            out.append(path)
        except CheckpointVerifyError:
            continue
    return out


def latest_verified_checkpoint(directory: str, *,
                               check_finite: bool = True):
    """Newest snapshot in ``directory`` that passes ``verify_checkpoint``
    (None when none does): torn, corrupt and, by default, non-finite
    snapshots are skipped."""
    if not os.path.isdir(directory):
        return None
    for f in reversed(_snapshots(directory)):
        path = os.path.join(directory, f)
        try:
            verify_checkpoint(path, check_finite=check_finite)
            return path
        except CheckpointVerifyError:
            continue
    return None


def _is_packed_plane(spec, leaf) -> bool:
    """Does this template leaf have the packed-buffer trailing shape?"""
    return (leaf.ndim >= 2 and leaf.shape[-2] == spec.rows
            and leaf.shape[-1] == 128)


def _entry_shape(data, key: str) -> tuple:
    """An npz entry's shape from its header, without reading its data."""
    with data.zip.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return tuple(read(f)[0])


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor over the same memory; ``|V2`` entries are
    bf16 words."""
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_state(path: str, template):
    """Restore ``path`` into ``template`` (a MetaState or nested dict of
    tensors of the saved structure) in place and return it.

    When ``template`` is a packed MetaState and the checkpoint was saved
    by the per-leaf path, each plane is packed through the template's spec
    on load. Entries are cast to the template's dtypes.
    """
    with np.load(path) as data:
        return _load_state(path, data, template)


def _load_state(path, data, template):
    spec = getattr(template, "spec", None)
    files = set(data.files)
    if PACKSPEC_KEY in files:
        # a packed plane of another leaf layout can still have the
        # template's (rows, 128) shape, so check the saved layout itself
        saved = json.loads(str(data[PACKSPEC_KEY][()]))
        want = spec.layout_dict() if spec is not None else None
        if saved != want:
            raise ValueError(
                f"checkpoint {path} was saved with a different packed "
                f"meta-plane layout than the restore template expects "
                f"(leaf paths/shapes/offsets differ, e.g. renamed or "
                f"reordered model params, or a per-leaf template for a "
                f"packed checkpoint); resume with the model/MAvgConfig "
                f"the run was saved under")
    # plan every copy first, so a refused checkpoint leaves the template
    # as it was
    plan, seen = [], files & {PACKSPEC_KEY}
    for key, leaf in _entries(template):
        if key in files:
            seen.add(key)
            sources, shape = key, _entry_shape(data, key)
        elif spec is not None and _is_packed_plane(spec, leaf) and all(
                f"{key}/{p}" in files for p in spec.paths):
            sources = [f"{key}/{p}" for p in spec.paths]
            seen |= set(sources)
            lead = tuple(leaf.shape[:-2])
            for k, s in zip(sources, spec.shapes):
                got = _entry_shape(data, k)
                if got != lead + tuple(s):
                    raise ValueError(
                        f"checkpoint {path} entry {k!r} has shape {got} but "
                        f"the restore template expects {lead + tuple(s)}")
            shape = tuple(leaf.shape)
        else:
            raise KeyError(
                f"checkpoint {path} has no entry {key!r}; it was saved under "
                f"a different MAvgConfig (comm / topology buffers only "
                f"exist when the feature was on at save time)")
        want = () if key == "step" and isinstance(leaf, int) else tuple(
            leaf.shape)
        if shape != want:
            raise ValueError(
                f"checkpoint {path} entry {key!r} has shape {shape} but the "
                f"restore template expects {want}; the run was saved under "
                f"a different MAvgConfig (e.g. another learner count, or a "
                f"different elastic membership schedule)")
        plan.append((key, leaf, sources))
    extra = sorted(files - seen)
    if extra:
        # silently dropping saved state (e.g. resuming a gossip run with
        # the flat topology would discard topo/params) diverges the run
        raise ValueError(
            f"checkpoint {path} carries entries the restore template does "
            f"not expect ({extra[:4]}{'...' if len(extra) > 4 else ''}); "
            f"resume with the MAvgConfig the run was saved under")
    step = None
    with torch.no_grad():
        for key, leaf, sources in plan:
            if isinstance(sources, str):
                arr = data[sources]
            else:
                arrs = [data[k] for k in sources]
                arr = spec.pack_numpy(arrs, dtype=arrs[0].dtype)
            if key == "step" and isinstance(leaf, int):
                step = int(arr)
            else:
                leaf.copy_(_to_tensor(arr))
    if step is not None:
        return dataclasses.replace(template, step=step)
    return template


def load_packspec(path: str) -> dict | None:
    """The ``__packspec__`` layout of a packed checkpoint (the decode map
    for external tools), or None for a per-leaf checkpoint."""
    with np.load(path) as data:
        if PACKSPEC_KEY not in data.files:
            return None
        return json.loads(str(data[PACKSPEC_KEY][()]))


def latest_checkpoint(directory: str):
    """Newest ``.npz`` in ``directory`` by name, verified or not."""
    if not os.path.isdir(directory):
        return None
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
    return os.path.join(directory, files[-1]) if files else None
