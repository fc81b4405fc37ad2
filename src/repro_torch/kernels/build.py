"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use on a machine with the CUDA toolkit, ``nvcc`` compiles each
source in ``SOURCES`` for ``sm_90a`` (one ``nvcc`` per source, all started
together) and links the objects into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library lands in
``<checkout>/build/repro_torch/<hash>/`` (listed in .gitignore), keyed on a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded from the previous build.

There is no fallback: without ``nvcc`` or without a card, loading raises.
Only CPU tensors take the plain PyTorch versions, and they never get here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "meta_kernels.cu", CSRC / "comm_kernels.cu",
           CSRC / "topology_kernels.cu", CSRC / "robust_kernels.cu",
           CSRC / "attention_hopper.cu", CSRC / "attention_hopper_f32.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_kernels.so"
# --fmad=false: no multiply-add contraction anywhere, so the kernels round
# exactly where their plain versions do (the sources also use the _rn
# intrinsics, which are never contracted)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
SIGNATURES = {
    "repro_fused_momentum_broadcast": (
        _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F32, _F32, _I32, _P),
    "repro_block_momentum": (_P, _P, _P, _P, _P, _I64, _F32, _F32, _I32, _P),
    "repro_sgd_apply": (_P, _P, _P, _I64, _I32, _F32, _P),
    "repro_quantize": (_P, _P, _P, _P, _I64, _I32, _I32, _P),
    "repro_dequantize": (_P, _P, _P, _I64, _I32, _P),
    "repro_pack_update": (
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P),
    "repro_pack_compress": (
        _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
    "repro_neighbor_mix": (_P, _P, _P, _I32, _I64, _I32, _P),
    "repro_robust_reduce": (_P, _P, _I32, _I64, _I32, _I32, _I32, _P),
    # q, k, v, o; B, H, KV, Sq, Sk, D; the (batch, seq, head) strides of
    # q, k, v and o; causal, window, prefix, kv_len, skip; scale: bfloat16
    # and float32 (3xTF32), both on the tensor cores
    "repro_flash_attention_hopper": (
        _P, _P, _P, _P, *(_I32,) * 6, *(_I64,) * 12, *(_I32,) * 5, _F32, _P),
    "repro_flash_attention_hopper_f32": (
        _P, _P, _P, _P, *(_I32,) * 6, *(_I64,) * 12, *(_I32,) * 5, _F32, _P),
}


class KernelLibrary:
    """The loaded library plus what its build printed and took."""

    def __init__(self, path: Path, build_log: str, build_s: float):
        self.path = path
        self.build_log = build_log
        self.build_s = build_s
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch one kernel; raise if the launch was refused."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: repro_torch's CUDA kernels are built at first use "
        "on a machine with the CUDA toolkit; CUDA tensors cannot run "
        "without them"
    )


def source_digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; their joined output, or raise with
    it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    return log


def build() -> tuple[Path, str, float]:
    """Compile the sources unless this hash was built already.

    Returns (library path, compiler output, seconds spent compiling).
    The library is written under a temporary name and renamed into
    place, so a concurrent or interrupted build never leaves a partial
    file where a loader would find it.
    """
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, "", 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in SOURCES]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(SOURCES, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, lib)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib, log, time.perf_counter() - t0


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The loaded kernel library, built on first call in this process."""
    global _LIBRARY
    if _LIBRARY is None:
        path, log, seconds = build()
        _LIBRARY = KernelLibrary(path, log, seconds)
    return _LIBRARY
