"""Atomic .npy artifact writes.

A copy of ``audio_tokens_tpu/utils/npy_io.py``, held equal to the original by
``tests/test_torch_train_data.py``.

Stages write thousands of artifacts that incremental resume later trusts by
existence; write-then-rename guarantees a killed run never leaves a truncated
file behind.  (np.save(path) appends '.npy' to unrecognized extensions, so
the temp file is written through an explicit handle.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def atomic_save_npy(path: Path, arr: np.ndarray) -> None:
    tmp = path.with_suffix(".npy.tmp")
    with open(tmp, "wb") as f:
        np.save(f, arr)
    tmp.replace(path)


def atomic_save_bytes(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    tmp.replace(path)
