"""Index which tar archive holds each ytid's audio (counterpart of
``audio_tokens_tpu/tools/sound_indexer.py``; reference:
tools/sound_indexer.py:1-36): writes a ytid,tar_path CSV.

Usage: python -m audio_tokens_tpu_torch.tools.sound_indexer --tars DIR
       [--out sound_index.csv]
"""

from __future__ import annotations

import argparse
import csv
import tarfile
from pathlib import Path

AUDIO_EXTS = (".flac", ".wav")


def index_tars(tar_dir: Path, out_csv: Path) -> int:
    rows = []
    for tar_path in sorted(tar_dir.glob("*.tar*")):
        with tarfile.open(tar_path) as tf:
            for member in tf:
                name = Path(member.name).name
                if member.isfile() and name.lower().endswith(AUDIO_EXTS):
                    rows.append((Path(name).stem, str(tar_path)))
    with out_csv.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["ytid", "tar_path"])
        writer.writerows(rows)
    print(f"indexed {len(rows)} clips from {tar_dir} -> {out_csv}")
    return len(rows)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--tars", required=True)
    parser.add_argument("--out", default="sound_index.csv")
    args = parser.parse_args()
    index_tars(Path(args.tars), Path(args.out))
