"""Expand AudioSet tar archives into the pipeline's directory layout.

Counterpart of ``audio_tokens_tpu/tools/audioset_expander.py`` (reference:
tools/audioset_expander.py:40-55): extracts the audio files of the
HuggingFace AudioSet tars and shards them into
``{audio_source_path}/{set}/{ytid[:2]}/{ytid}.flac``, the layout
``data/audio_io.find_audio_file`` probes.

Usage: python -m audio_tokens_tpu_torch.tools.audioset_expander --tars DIR
       [--set bal_train] [<config flags>]
"""

from __future__ import annotations

import argparse
import logging
import os
import tarfile
from pathlib import Path

from audio_tokens_tpu_torch.config import AudioTokensConfig

logger = logging.getLogger(__name__)

AUDIO_EXTS = (".flac", ".wav")


def expand_tar(tar_path: Path, dest_root: Path, source_set: str) -> int:
    n = 0
    with tarfile.open(tar_path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            name = Path(member.name).name
            if not name.lower().endswith(AUDIO_EXTS):
                continue
            # normalize the extension: find_audio_file probes the literal
            # lowercase '{ytid}.flac'/'{ytid}.wav', so '.FLAC' members would
            # be expanded yet never found by any stage
            stem, ext = Path(name).stem, Path(name).suffix.lower()
            ytid = stem
            out_dir = dest_root / source_set / ytid[:2]
            out_dir.mkdir(parents=True, exist_ok=True)
            out_path = out_dir / f"{stem}{ext}"
            if out_path.exists():
                continue
            src = tf.extractfile(member)
            if src is None:
                continue
            # write-then-rename: resume-by-existence must never trust a
            # truncated file from an interrupted run
            tmp = out_path.with_name(out_path.name + f".tmp.{os.getpid()}")
            tmp.write_bytes(src.read())
            os.replace(tmp, out_path)
            n += 1
    return n


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tars", required=True, help="directory containing .tar files")
    parser.add_argument("--set", default="bal_train", dest="source_set")
    args, rest = parser.parse_known_args()
    config = AudioTokensConfig.from_args(rest)

    dest = Path(config.audio_source_path)
    total = 0
    for tar_path in sorted(Path(args.tars).glob("*.tar*")):
        n = expand_tar(tar_path, dest, args.source_set)
        logger.info("%s: %d audio files", tar_path.name, n)
        total += n
    logger.info("expanded %d files into %s/%s", total, dest, args.source_set)


if __name__ == "__main__":
    main()
