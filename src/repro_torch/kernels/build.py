"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and is
compiled on its own by ``nvcc`` for ``sm_90a`` into a ``.so`` under
``build/kernels/<source hash>/`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``.  The build runs at first
use and is keyed by a hash of the source and the flags, so a checkout
builds everything it needs by itself and an edited source rebuilds.

:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them, so the build costs the time of the slowest file.

The wrappers of every source share the launch helpers at the end:
:class:`Library` binds a source's entry points and raises on a refused
launch, :func:`on_cuda` picks the route (plain version on the CPU, kernel
on the card, nothing else), :func:`stream` gives PyTorch's stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fused_bucket": CSRC / "fused_bucket.cu",
           "per_tensor": CSRC / "per_tensor.cu",
           "flash_attention": CSRC / "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
# per source: -Xptxas -v puts each kernel's registers, shared memory and
# spills into the build log (:func:`build_log`)
EXTRA_FLAGS = {"flash_attention": ("-Xptxas", "-v"),
               "fused_bucket": ("-Xptxas", "-v")}

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


def _flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def _target(name: str) -> Path:
    src = SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return build_dir() / key.hexdigest()[:16] / f"lib{name}.so"


def build_log(name: str) -> str:
    """nvcc's output from building ``name`` ("" if it printed nothing)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, temporary output, Popen), the last two None when built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name].name} "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
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


class Library:
    """The entry points of one source, bound at first call.

    ``signatures`` maps each ``extern "C"`` function to its ctypes
    argument types; every entry point returns a CUDA error code, and a
    call raises unless it is 0 (a refused launch never runs, and no later
    synchronize reports it)."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.signatures = signatures
        self._lib = None

    def __call__(self, fn: str, *args):
        if self._lib is None:
            lib = load(self.name)
            for f, argtypes in self.signatures.items():
                getattr(lib, f).argtypes = argtypes
                getattr(lib, f).restype = ctypes.c_int
            self._lib = lib
        err = getattr(self._lib, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def on_cuda(*tensors) -> bool:
    """True when every tensor is on CUDA, False when all are on the CPU;
    raises on a mix or any other device.  A wrapper runs its plain version
    on False and launches its kernel on True: there is no fallback."""
    if all(t.is_cuda for t in tensors):
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"the port's kernels take all-CPU or all-CUDA tensors, "
                     f"got {kinds}")


def stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as a pointer-sized int:
    the raw handle, without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds first (~3 µs a call on the host)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())
