"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first use into
a shared library under ``_build/`` (listed in ``.gitignore``), keyed by a hash of
its source, the headers it includes with quotes (``kernels/csrc/hopper.cuh``) and
the flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Nothing is compiled when a module is imported: the CPU tests
import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


@dataclass(frozen=True)
class BuildResult:
    library: Path
    log: str  # nvcc's output: -Xptxas -v registers, shared memory and spills
    seconds: float  # 0.0 when the library was already built
    cached: bool


_LIBS: dict[Path, ctypes.CDLL] = {}
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; cannot build CUDA kernels")


def sources(source: Path) -> list[Path]:
    """``source`` and every file it includes with quotes, directly or through another,
    each resolved against the directory of the file that includes it."""
    seen, todo = [], [Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            includes = _QUOTED_INCLUDE.findall(path.read_text())
            todo.extend((path.parent / inc).resolve() for inc in reversed(includes))
    return seen


def tag(source: Path) -> str:
    """Hash of ``source``, the headers it includes and the flags: the library's key."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(source):
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(source: Path) -> BuildResult:
    """Compile ``source`` into a shared library, unless it is already built."""
    source = Path(source).resolve()
    library = BUILD_DIR / f"{source.stem}-{tag(source)}.so"
    if library.exists():
        return BuildResult(library, "", 0.0, cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode} on {source}:\n{log}")
    os.replace(tmp, library)  # atomic: a concurrent process never loads half a file
    return BuildResult(library, log, seconds, cached=False)


def load(source: Path) -> ctypes.CDLL:
    """The loaded library built from ``source`` (built first if needed)."""
    source = Path(source).resolve()
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(str(build(source).library))
    return _LIBS[source]


def refuse_dtensors(kernel: str, *tensors):
    """Raise TypeError when a tensor is a DTensor: a kernel reads one device's memory,
    so a sharded caller hands it local shards (``local_call``), never the whole."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{kernel} takes local tensors, got a DTensor: call it on the local shards "
            "(distributed.sharding.local_call)"
        )
