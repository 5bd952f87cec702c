"""Print an .npy array (counterpart of ``audio_tokens_tpu/tools/
numpy_view.py``; reference: tools/numpy_view.py).

Usage: python -m audio_tokens_tpu_torch.tools.numpy_view ARRAY.npy
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    arr = np.load(argv[0])
    np.set_printoptions(threshold=200, edgeitems=5)
    print(f"shape={arr.shape} dtype={arr.dtype} min={arr.min():.4g} max={arr.max():.4g}")
    print(arr)


if __name__ == "__main__":
    main()
