"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface and is compiled on first
use by one ``nvcc`` process per source, all started together, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -ftz=true \\
         -shared -Xcompiler -fPIC -Xptxas -v \\
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

``-ftz=true`` flushes subnormal fp32 inputs and results of arithmetic and
comparisons to zero, as XLA does on the CPU and the TPU, where the reference
computes; the kernels also flush explicitly wherever a value's bits or its
conversion to fp64 are read (neither is flushed by the flag).

The compiler's output (``-Xptxas -v``: each kernel's registers, shared
memory and spills) is kept beside the library and read by
:func:`build_log`.

The library name carries a hash of its source and of the flags, so an
edited kernel is never served from a stale build.  Libraries are loaded
with ``ctypes``; every C entry takes its pointers and PyTorch's current
stream as ``void*`` and returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

``LAUNCHES`` counts kernel launches by name: one name a source, and one
more for each source's second kernel (``COUNTED``).  A wrapper records one
launch where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "COUNTED", "LAUNCHES", "LaunchCounter", "build_all",
           "build_log", "library", "entry", "check", "stream_ptr", "on_card"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("stc_apply", "histogram", "bin_select", "pack_bits",
           "pack_chunks", "unpack_bits", "golomb_decode", "threshold_stats",
           "bisect_select")
# the launch counters: each source's kernel, plus the fp32 sign-plane pack
# of pack_bits.cu and the sign-plane tally of unpack_bits.cu
COUNTED = SOURCES + ("pack_sign_planes", "sign_plane_tally")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-ftz=true", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


class LaunchCounter:
    """Kernel launches by name, plus the shape of each kernel's last
    launch (the shapes the main path handed it)."""

    def __init__(self):
        self.counts: dict[str, int] = {name: 0 for name in COUNTED}
        self.shapes: dict[str, tuple] = {}

    def record(self, name: str, shape: tuple) -> None:
        self.counts[name] += 1
        self.shapes[name] = tuple(shape)

    def reset(self) -> None:
        for name in self.counts:
            self.counts[name] = 0
        self.shapes.clear()


LAUNCHES = LaunchCounter()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, in parallel.
    Raises with the compiler's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed when ``csrc/<name>.cu`` was built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _LOCK:
        if name not in _LIBS:
            for lib_name, path in build_all().items():
                _LIBS.setdefault(lib_name, ctypes.CDLL(str(path)))
        return _LIBS[name]


def entry(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``, its argument types
    declared once (pointers and the stream as ``c_void_p``); a launching
    entry returns a ``cudaError_t`` as ``int``."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def on_card(t: torch.Tensor) -> bool:
    """Where a wrapper runs: True for a CUDA tensor (it launches its
    kernel), False for a CPU tensor (its plain version); raises for any
    other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the integer handle the C
    entries take."""
    return torch.cuda.current_stream(device).cuda_stream
