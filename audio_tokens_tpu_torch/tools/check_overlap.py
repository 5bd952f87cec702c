"""Assert the train/validation split is disjoint (counterpart of
``audio_tokens_tpu/tools/check_overlap.py``; reference:
tools/check_overlap.py:5-11).

Usage: python -m audio_tokens_tpu_torch.tools.check_overlap [<config flags>]
"""

from __future__ import annotations

import json

from audio_tokens_tpu_torch.config import AudioTokensConfig


def check_overlap(split_file: str) -> int:
    with open(split_file) as f:
        split = json.load(f)
    overlap = set(split["train"]) & set(split["validation"])
    assert not overlap, f"{len(overlap)} ytids in both splits: {sorted(overlap)[:5]}"
    print(
        f"OK: {len(split['train'])} train / {len(split['validation'])} validation, "
        "no overlap"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(check_overlap(AudioTokensConfig.from_args().split_file))
