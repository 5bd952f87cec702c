"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>.so`` at the root
of the checkout (``build/`` is gitignored), compiled by ``nvcc`` for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>.so csrc/<name>.cu

The sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  A library is rebuilt when any source in ``csrc/`` is
newer than it.  ``--use_fast_math`` is deliberately absent: its log10, sqrt
and division change token decisions.  ``ptxas`` reports each kernel's
registers, shared memory and spills into ``lib<name>.log`` beside the
library.

Every pointer and the stream cross the ctypes boundary as ``c_void_p`` and
every int as ``c_int``; each exported function returns the CUDA error code
of its launch (0 on success), which the wrapper turns into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("vq", "tokenizer", "lstm", "attention", "kmeans")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def nvcc_command(name: str, out: Path, defines: Iterable[str] = ()) -> list:
    """The nvcc command line that compiles ``csrc/<name>.cu`` into ``out``,
    with ``-D<define>`` for each of ``defines`` (a source's tuning knobs)."""
    return [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every stale library among ``names`` (in parallel); return
    the seconds taken.  Raises with nvcc's output if a compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(BUILD_DIR / f"lib{name}.log", "w")
        procs.append((name, tmp, log, subprocess.Popen(
            nvcc_command(name, tmp), stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))  # atomic: no half-written .so
    if failed:
        msgs = [(BUILD_DIR / f"lib{n}.log").read_text() for n in failed]
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(msgs))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
        lib.atk_error_string.argtypes = [ctypes.c_int]
        lib.atk_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a nonzero CUDA error code."""
    if rc:
        msg = lib.atk_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


SMEM_LIMIT = 232448  # dynamic shared memory a block may have on the H100

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_long
