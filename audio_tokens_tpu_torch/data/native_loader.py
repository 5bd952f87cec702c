"""ctypes binding for the native audio decoder (``native/audiodec.cpp``).

The port's own binding of the framework-free C++ decoder that the JAX
package also uses (``audio_tokens_tpu/data/native_loader.py``, ABI 3): WAV
(PCM 8/16/24/32, float 32/64, WAVE_FORMAT_EXTENSIBLE) and FLAC, downmix to
mono by the channel mean, polyphase resampling, and a thread-pool batch
decode straight into the reflect-padded ``(B, pad+clip+pad)`` layout the
mel frontend and kernel B1 read.

The library is compiled from the shared source at first use with the flags
of ``native/build.py`` (plain g++, no dependency beyond pthreads) into
``build/native/libaudiodec.so`` at the root of the checkout (gitignored):

    g++ -std=c++17 -shared -fPIC -O3 -funroll-loops -Wall -Wextra
        -o build/native/libaudiodec.so native/audiodec.cpp -lpthread

It is rebuilt when the source is newer, compiled to a temporary name and
moved into place with ``os.replace``, so that processes building at once
never load a half-written library.  Nothing is written into ``native/``.

``select_backend(config)`` is the stages' choice: ``audio_backend="native"``
raises when the library cannot be built or loaded, ``"auto"`` takes it
where it loads (logging which decoder it took), ``"python"`` never does.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "audiodec.cpp"
LIB_PATH = ROOT / "build" / "native" / "libaudiodec.so"
GXX_FLAGS = ("-std=c++17", "-shared", "-fPIC", "-O3", "-funroll-loops",
             "-Wall", "-Wextra")
ABI = 3
BACKENDS = ("auto", "native", "python")

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def build(source: Path = None, out: Path = None) -> Path:
    """Compile ``source`` into ``out`` unless ``out`` is newer; raises
    RuntimeError with g++'s output if the compile fails."""
    source = Path(source or SOURCE)
    out = Path(out or LIB_PATH)
    if not source.exists():
        raise RuntimeError(f"native decoder source missing: {source}")
    if out.exists() and out.stat().st_mtime >= source.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(source), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++
        raise RuntimeError(f"cannot run g++: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: no reader sees a half-written library
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first where stale; raises RuntimeError
    (and remembers why) when it cannot be built or loaded."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        raise RuntimeError(_load_error)
    try:
        lib = ctypes.CDLL(str(build()))
        lib.atk_version.restype = ctypes.c_int
        lib.atk_last_error.restype = ctypes.c_char_p
        lib.atk_decode_file.restype = ctypes.c_int64
        lib.atk_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.atk_decode_batch.restype = ctypes.c_int
        lib.atk_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ]
        got = lib.atk_version()
        if got != ABI:
            raise RuntimeError(f"libaudiodec ABI {got} != {ABI}")
    except (OSError, RuntimeError) as e:
        _load_error = f"native audio decoder unavailable: {e}"
        raise RuntimeError(_load_error) from e
    _lib = lib
    logger.info("native audio decoder loaded: %s", LIB_PATH)
    return lib


def available() -> bool:
    try:
        load()
    except RuntimeError as e:
        logger.warning("%s", e)
        return False
    return True


def select_backend(config) -> bool:
    """Whether a stage decodes natively under ``config.audio_backend``;
    ``"native"`` raises if the library cannot be built or loaded."""
    backend = config.audio_backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown audio_backend '{backend}' "
                         f"(use {'|'.join(BACKENDS)})")
    if backend == "native":
        load()
        native = True
    else:
        native = backend == "auto" and available()
    logger.info("audio decode backend: %s",
                "native C++" if native else "python")
    return native


def last_error() -> str:
    return load().atk_last_error().decode()


def decode_file(path, target_sr: int, max_seconds: float = 60.0) -> np.ndarray:
    """Decode one file to mono float32 at ``target_sr``."""
    lib = load()
    max_samples = int(target_sr * max_seconds)
    out = np.empty(max_samples, np.float32)
    n = lib.atk_decode_file(
        str(path).encode(), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples)
    if n < 0:
        raise RuntimeError(f"decode failed for {path}: {last_error()}")
    return out[:n].copy()


def decode_batch(paths: List, target_sr: int, clip_samples: int, n_fft: int,
                 n_threads: int = 8, row_len: Optional[int] = None,
                 dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode -> (padded (B, row_len) ``dtype``, lengths
    (B,) int32).

    ``row_len`` (default pad+clip+pad) sets the row stride.
    ``dtype=np.int16`` is the PCM wire (sample = round(x * 32768),
    clamped), half the host-to-card bytes, reconstructed on the card as
    s / 32768 (``ops/mel.decode_wire``).  ``lengths[i] == -1`` marks a
    failed decode (row zeroed); the caller skips and logs it."""
    lib = load()
    dtype = np.dtype(dtype)
    try:
        fmt = {np.dtype(np.float32): 0, np.dtype(np.int16): 1}[dtype]
    except KeyError:
        raise ValueError(f"dtype must be float32 or int16, got {dtype}")
    n = len(paths)
    row_min = clip_samples + 2 * (n_fft // 2)
    if row_len is None:
        row_len = row_min
    elif row_len < row_min:
        raise ValueError(f"row_len {row_len} < clip+2*pad {row_min}")
    out = np.empty((n, row_len), dtype)  # fully written by the library
    lengths = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.atk_decode_batch(
        c_paths, n, target_sr, clip_samples, n_fft, n_threads,
        ctypes.c_int64(row_len), fmt, out.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise RuntimeError(f"decode_batch failed: {last_error()}")
    return out, lengths
