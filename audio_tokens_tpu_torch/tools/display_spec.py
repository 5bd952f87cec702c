"""Render a saved spectrogram .npy to a PNG (counterpart of
``audio_tokens_tpu/tools/display_spec.py``; reference: tools/display_spec.py,
which used librosa.specshow interactively).  Needs matplotlib.

Usage: python -m audio_tokens_tpu_torch.tools.display_spec SPEC.npy [OUT.png]
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    argv = sys.argv[1:] if argv is None else list(argv)
    path = Path(argv[0])
    out = Path(argv[1]) if len(argv) > 1 else path.with_suffix(".png")
    spec = np.load(path)
    fig, ax = plt.subplots(figsize=(12, 4))
    im = ax.imshow(spec, origin="lower", aspect="auto", cmap="magma")
    fig.colorbar(im, label="dB")
    ax.set_xlabel("frame")
    ax.set_ylabel("mel bin")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
