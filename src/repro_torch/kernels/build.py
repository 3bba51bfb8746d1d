"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and is
compiled on its own by ``nvcc`` for ``sm_90a`` into a ``.so`` under
``build/kernels/<source hash>/`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``.  The build runs at first
use and is keyed by a hash of the source and the flags, so a checkout
builds everything it needs by itself and an edited source rebuilds.

:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them, so the build costs the time of the slowest file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fused_bucket": CSRC / "fused_bucket.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` at the repository root (``src/..``), or the
    directory named by ``REPRO_TORCH_BUILD_DIR``."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin, default /usr/local/cuda/bin): the "
                       "port's CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / key.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, temporary output, Popen), the last two None when built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name].name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)           # atomic: readers never see a partial .so
    return out


def build_all() -> dict[str, Path]:
    """Compile every source that is not built yet, all in parallel."""
    started = {n: _start(n) for n in SOURCES}
    return {n: _finish(n, *st) for n, st in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_finish(name, *_start(name))))
        _LOADED[name] = lib
    return lib
