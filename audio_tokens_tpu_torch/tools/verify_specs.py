"""Validate saved spectrogram artifacts: shapes, dtype, finiteness.

Counterpart of ``audio_tokens_tpu/tools/verify_specs.py``, a working
replacement for the reference's verifier (reference: tools/verify_specs.py:2
imported a module that no longer exists).  Returns 1 if any file is bad.

Usage: python -m audio_tokens_tpu_torch.tools.verify_specs [<config flags>]
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from audio_tokens_tpu_torch.config import AudioTokensConfig


def verify_specs(config: AudioTokensConfig) -> int:
    bad = 0
    total = 0
    for split in ("train", "validation"):
        spec_dir = Path(config.source_spec_path) / split
        for f in sorted(spec_dir.glob("*.npy")):
            total += 1
            spec = np.load(f)
            problems = []
            if spec.ndim != 2 or spec.shape[0] != config.n_mels:
                problems.append(f"bad shape {spec.shape}")
            if spec.dtype != np.float32:
                problems.append(f"bad dtype {spec.dtype}")
            if not np.isfinite(spec).all():
                problems.append("NaN/Inf values")
            if problems:
                bad += 1
                print(f"BAD {f}: {', '.join(problems)}")
    print(f"checked {total} spectrograms, {bad} bad")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(verify_specs(AudioTokensConfig.from_args()))
