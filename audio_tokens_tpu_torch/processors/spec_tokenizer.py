"""Stage 3: spectrograms -> nearest-centroid token-ID sequences.

Counterpart of the staged path of
``audio_tokens_tpu/processors/spec_tokenizer.py``, with the same artifact
contract (reference: processors/spec_tokenizer.py:41-90): reads
``{source_spec_path}/{split}/*.npy`` in sorted order, writes one int64
token array per clip to ``{dest_tokenized_path}/{split}/{ytid}.npy`` (one
token per STFT frame), wipes output dirs per run (or, with
``incremental=True``, re-tokenizes only missing or stale clips), and on the
train split reports whole-corpus token statistics from a
``train.token_counts.npz`` ledger, with distribution and Zipf plots where
matplotlib is installed.

Each batch of ``tokenizer_batch_size`` files is one ``vq_assign_fused``
call with ``normalize=True`` on the stage's device (``cuda:0`` unless the
caller passes another): kernel B2 on the card, its plain version on the
CPU.  Under ``use_convolution`` the frames first go through the conv
front-end with the clustering stage's weights (``<centroids>.conv.npz``;
the seeded draw where that file is missing), as the JAX stage does.

``fused_pipeline=True`` reads no spectrogram file and writes the same
token files: clips go wav -> tokens through ``FusedTokenizer`` (kernel B1)
in ``device_batch_size`` batches of sorted clips, except the train clips
that the clustering stage's device feed left resident
(``resident_frames``), which B2 assigns from those frames (``normalize=
False``: the rows are already unit) without decoding them again.  The fused
mode decodes with the native decoder where ``audio_backend`` takes it
(``data/native_loader.select_backend``), one batch straight into the
kernel's padded layout (int16 under ``pcm_wire="i16"``), else with the
python decode.

Multi-process runs (``parallel/distributed.py``): each rank tokenizes its
strided shard of each split (B1 or B2 on its own card, no collective in
the work), rank 0 alone makes or wipes the output dirs, with barriers
around, the ranks' token counts are summed before rank 0 writes the
ledger and the plots, and every rank returns the same statistics.

The wire meter (``utils/profiling.WIRE``) counts the staged mode's frames
up and tokens down, the native fused mode's waveforms up and tokens down,
and times the resident assignment as a device section; with a
``profile_dir`` each split's tokenizing is traced
(``utils/profiling.maybe_trace``).
"""

from __future__ import annotations

import io
import json
import logging
import shutil
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data import native_loader
from audio_tokens_tpu_torch.data.audio_io import decode_clip, find_audio_file
from audio_tokens_tpu_torch.ops.mel import num_frames
from audio_tokens_tpu_torch.ops.vq import vq_assign_fused
from audio_tokens_tpu_torch.parallel import distributed
from audio_tokens_tpu_torch.processors.cluster_creator import (
    make_conv_features,
)
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.utils.npy_io import (atomic_save_bytes,
                                                 atomic_save_npy)
from audio_tokens_tpu_torch.utils.profiling import (WIRE, StageTimer,
                                                    maybe_trace)
from audio_tokens_tpu_torch.utils.seeding import set_seed

logger = logging.getLogger(__name__)


def _token_file_ok(path: Path) -> bool:
    """Cheap structural validation of an existing token .npy (header parse +
    mmap length check — the data bytes are never read).  Incremental runs on
    splits WITHOUT a count ledger (validation) use this so a corrupt file is
    re-tokenized instead of being skipped forever by the exists+mtime check;
    the train split's ledger catch-up np.loads those files anyway."""
    try:
        np.load(path, mmap_mode="r")
        return True
    except Exception:
        return False


class _CountLedger:
    """Whole-corpus token statistics across incremental runs (a copy of the
    JAX stage's ledger, same file layout).

      * ``{split}.token_counts.npz`` next to the token dir persists the
        aggregate per-token counts plus a MANIFEST of the clip stems they
        cover and the centroid mtime they were computed against;
      * on an incremental run, fresh already-tokenized clips NOT in the
        manifest are "caught up" by bincounting their token files;
      * the prior is dropped wholesale when the centroids changed or when a
        manifest clip's token file disappeared.

    Net effect: incremental-run statistics match a destructive rerun's.
    """

    def __init__(self, token_dir: Path, vocab: int, cent_mtime: float,
                 load_prior: bool):
        self.token_dir = token_dir
        self.path = token_dir.parent / f"{token_dir.name}.token_counts.npz"
        self.vocab = vocab
        self.cent_mtime = cent_mtime
        self.prior = np.zeros(vocab, np.int64)
        self.prior_set = frozenset()
        if not load_prior or not self.path.exists():
            return
        try:
            z = np.load(self.path, allow_pickle=False)
            if float(z["cent_mtime"]) != cent_mtime:
                return  # new codebook: every prior count is stale
            counts = np.asarray(z["counts"], np.int64)
            if counts.shape != (vocab,):
                return
            stems = set(str(s) for s in z["ytids"])
            on_disk = {f.stem for f in token_dir.glob("*.npy")}
            if not stems <= on_disk:
                logger.info(
                    "token-count ledger dropped: %d counted clips no longer "
                    "on disk", len(stems - on_disk))
                return
            self.prior = counts
            self.prior_set = frozenset(stems)
        except Exception as e:
            logger.warning("token-count ledger unreadable (%s); rebuilding", e)

    def catchup_counts(self, fresh_stems):
        """(counts, failed_stems) for already-tokenized clips outside the
        manifest.  A clip whose token file turns out unreadable (e.g. a
        torn write from a killed run) is deleted and returned in
        ``failed_stems`` so the caller re-tokenizes it."""
        counts = np.zeros(self.vocab, np.int64)
        missing = [s for s in fresh_stems if s not in self.prior_set]
        failed = []
        for stem in missing:
            try:
                toks = np.load(self.token_dir / f"{stem}.npy")
                counts += np.bincount(np.asarray(toks, np.int64),
                                      minlength=self.vocab)
            except Exception as e:
                logger.warning("token file %s unreadable (%s); re-tokenizing",
                               stem, e)
                (self.token_dir / f"{stem}.npy").unlink(missing_ok=True)
                failed.append(stem)
        if missing:
            logger.info("token-count ledger: caught up %d clips from token "
                        "files", len(missing) - len(failed))
        return counts, failed

    def save(self, merged_counts: np.ndarray) -> None:
        """Persist merged counts + the manifest of fresh clips they cover
        (atomic)."""
        manifest = sorted(
            f.stem for f in self.token_dir.glob("*.npy")
            if f.stat().st_mtime >= self.cent_mtime
        )
        buf = io.BytesIO()
        np.savez(buf, counts=np.asarray(merged_counts, np.int64),
                 ytids=np.asarray(manifest),
                 cent_mtime=np.float64(self.cent_mtime))
        atomic_save_bytes(self.path, buf.getvalue())


class SpecTokenizer:
    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None,
                 resident_frames=None):
        """``resident_frames``: ``ClusterCreator.take_resident_frames()``,
        the device feed's L2-normalized train frames (a view on the
        stage's device) and ``{ytid: (row, frames)}``; the fused mode
        assigns the clips it covers from it."""
        self.config = config
        self.resident = resident_frames
        distributed.maybe_initialize(config)
        self.device = (distributed.default_device() if device is None
                       else torch.device(device))
        set_seed(config.random_seed)
        self.source_path = Path(config.source_spec_path)
        self.dest_tokenized_path = Path(config.dest_tokenized_path)
        self.centroids = torch.from_numpy(
            np.load(config.centroids_path).astype(np.float32)).to(self.device)
        self.conv = make_conv_features(config, self.device)
        if self.conv is not None:
            state = Path(config.centroids_path).with_suffix(".conv.npz")
            if state.exists():
                self.conv.load_state_dict(dict(np.load(state)))

    @property
    def vocab(self) -> int:
        return self.centroids.shape[0]

    def run(self) -> Dict[str, dict]:
        if self.config.fused_pipeline:
            return self._run_fused()
        stats = {}
        for split in ["train", "validation"]:
            source_dir = self.source_path / split
            tokenized_dir = self.dest_tokenized_path / split
            self._prepare_dir(tokenized_dir, f"tok-{split}")
            logger.info("Tokenizing %s: %s --> %s", split, source_dir,
                        tokenized_dir)
            ledger = self._make_ledger(split, tokenized_dir)
            with maybe_trace(self.config.profile_dir, self.device), \
                    StageTimer(f"tokenize/{split}") as timer:
                counts, fresh_frames = self.tokenize_directory(
                    source_dir, tokenized_dir, ledger)
                # only frames tokenized THIS run count toward the stage's
                # throughput; ledger catch-up bincounts are cheap host reads
                timer.count("frames", fresh_frames)
            distributed.barrier(f"tok-done-{split}")
            if split == "train":
                stats[split] = self._finish_train_stats(counts, ledger)
        return stats

    def _prepare_dir(self, tokenized_dir: Path, name: str) -> None:
        """The split's output dir, kept (incremental) or wiped (the
        reference's destructive restart), by rank 0 before any rank
        writes."""
        if distributed.is_coordinator():
            if not self.config.incremental:
                shutil.rmtree(tokenized_dir, ignore_errors=True)
            tokenized_dir.mkdir(parents=True, exist_ok=True)
        distributed.barrier(f"{name}-ready")

    def _make_ledger(self, split: str, tokenized_dir: Path):
        """Ledger for the train split's whole-corpus statistics (prior counts
        only load on incremental runs; destructive runs rebuild and save)."""
        if split != "train":
            return None
        cent_mtime = Path(self.config.centroids_path).stat().st_mtime
        return _CountLedger(tokenized_dir, self.vocab, cent_mtime,
                            load_prior=self.config.incremental)

    def _finish_train_stats(self, counts: np.ndarray, ledger) -> dict:
        """Whole-corpus counts (summed over the ranks) -> stats + plots +
        persisted ledger (rank 0's)."""
        counts = distributed.all_sum_hosts(counts) + ledger.prior
        if counts.sum() == 0:
            logger.info("no tokens on record; skipping statistics/plots")
            return {"total_tokens": 0, "unique_tokens": 0}
        stats = self.analyze_token_counts(counts)
        if distributed.is_coordinator():
            ledger.save(counts)
            self.plot_token_counts(counts)
        return stats

    def tokenize_directory(self, source_dir: Path, tokenized_dir: Path,
                           ledger=None):
        """Tokenize every spec file; returns (per-token counts (vocab,),
        frames tokenized this run).  On incremental runs the counts include
        the caught-up already-tokenized clips (see _CountLedger); the frame
        count covers only freshly tokenized clips."""
        counts = np.zeros(self.vocab, np.int64)
        spec_files = distributed.process_shard(sorted(source_dir.glob("*.npy")))
        if self.config.incremental:
            by_stem = {f.stem: f for f in spec_files}
            spec_files = [by_stem[s] for s in self._incremental_todo(
                list(by_stem), tokenized_dir, ledger, counts)]
        bs = self.config.tokenizer_batch_size
        fresh_frames = 0
        for i in range(0, len(spec_files), bs):
            batch_tokens = self.process_batch(spec_files[i : i + bs],
                                              tokenized_dir)
            counts += np.bincount(batch_tokens, minlength=len(counts))
            fresh_frames += len(batch_tokens)
        return counts, fresh_frames

    def _incremental_todo(self, stems: List[str], tokenized_dir: Path,
                          ledger, counts: np.ndarray) -> List[str]:
        """The clips (of ``stems``, in order) an incremental run must
        tokenize: those without a token file written after the current
        centroids (an older one encodes a stale codebook), then those whose
        file the ledger's catch-up found unreadable; ``counts`` gains the
        caught-up counts of the rest."""
        cent_mtime = Path(self.config.centroids_path).stat().st_mtime
        skipped, todo = [], []
        for stem in stems:
            tok = tokenized_dir / f"{stem}.npy"
            if tok.exists() and tok.stat().st_mtime >= cent_mtime and (
                    ledger is not None or _token_file_ok(tok)):
                skipped.append(stem)
            else:
                todo.append(stem)
        logger.info("incremental: %d/%d clips already tokenized",
                    len(skipped), len(stems))
        if ledger is not None:
            caught, failed = ledger.catchup_counts(skipped)
            counts += caught
            todo += failed  # unreadable token files: re-tokenize those
        return todo

    def process_batch(self, batch_files: List[Path],
                      tokenized_dir: Path) -> np.ndarray:
        batch_specs = [np.load(f).T for f in batch_files]  # (T_i, n_mels) each
        frames = np.concatenate(batch_specs, axis=0).astype(np.float32)
        WIRE.h2d(frames)  # staged mode: mel frames up, tokens down
        frames = torch.from_numpy(frames).to(self.device)
        if self.conv is not None:
            frames = self.conv(frames)
        tokens = vq_assign_fused(frames, self.centroids, normalize=True,
                                 ).cpu().numpy().astype(np.int64)
        WIRE.d2h(tokens)

        start = 0
        for spec_file, spec in zip(batch_files, batch_specs):
            end = start + len(spec)
            atomic_save_npy(tokenized_dir / f"{spec_file.stem}.npy",
                            tokens[start:end])
            start = end
        return tokens

    # ------------------------------------------------------------------
    # Fused mode: wav -> tokens on the device, no spectrogram files
    # ------------------------------------------------------------------
    def _run_fused(self) -> Dict[str, dict]:
        """Tokenize straight from audio (``fused_pipeline=True``): the
        staged mode's artifacts, ledger and statistics, from
        ``FusedTokenizer`` (B1) batches of ``device_batch_size`` sorted
        clips, and from the resident frames where the train split has
        them."""
        cfg = self.config
        with open(cfg.split_file) as f:
            split_map = json.load(f)
        ft = FusedTokenizer(cfg, self.centroids.cpu().numpy(), self.device,
                            conv=self.conv)
        use_native = native_loader.select_backend(cfg)
        fused_tokens = (self._fused_tokens_native if use_native
                        else self._fused_tokens_python)
        stats: Dict[str, dict] = {}
        for split in ["train", "validation"]:
            tokenized_dir = self.dest_tokenized_path / split
            self._prepare_dir(tokenized_dir, f"ftok-{split}")
            # the staged glob's order; each rank takes its strided slice
            ytids = distributed.process_shard(sorted(split_map[split]))
            ledger = self._make_ledger(split, tokenized_dir)
            counts = np.zeros(self.vocab, np.int64)
            if cfg.incremental:
                ytids = self._incremental_todo(ytids, tokenized_dir, ledger,
                                               counts)
            logger.info("Fused-tokenizing %s: audio --> %s", split,
                        tokenized_dir)
            n_todo = len(ytids)
            resident_work = None
            if self.resident is not None and split == "train":
                frames, manifest = self.resident
                covered = [y for y in ytids if y in manifest]
                if covered:
                    resident_work = (frames, manifest, covered)
                    ytids = [y for y in ytids if y not in manifest]
                # the stage's last reference: the frames live until the
                # assignment below, not into training
                self.resident = frames = None
            found = [(y, p) for y in ytids
                     if (p := find_audio_file(cfg, y)) is not None]
            n_clips = n_frames = 0
            bs = cfg.device_batch_size
            with maybe_trace(cfg.profile_dir, self.device), \
                    StageTimer(f"tokenize-fused/{split}") as timer:
                resident_tokens: Dict[str, np.ndarray] = {}
                if resident_work is not None:
                    resident_tokens = self._assign_resident(*resident_work)
                    resident_work = None
                    logger.info("resident frames: %d clips tokenized with "
                                "no decode", len(resident_tokens))
                batches = (fused_tokens(ft, found[i : i + bs])
                           for i in range(0, len(found), bs))
                for ytid, toks in chain(resident_tokens.items(),
                                        chain.from_iterable(batches)):
                    atomic_save_npy(tokenized_dir / f"{ytid}.npy", toks)
                    if split == "train":
                        counts += np.bincount(toks, minlength=self.vocab)
                    n_frames += len(toks)
                    n_clips += 1
                timer.count("clips", n_clips)
                timer.count("frames", n_frames)
            distributed.barrier(f"ftok-done-{split}")
            logger.info("%s: %d/%d clips tokenized (fused)", split, n_clips,
                        n_todo)
            if split == "train":
                stats[split] = self._finish_train_stats(counts, ledger)
        return stats

    def _assign_resident(self, frames: torch.Tensor, manifest: dict,
                         covered: List[str]) -> Dict[str, np.ndarray]:
        """Per-clip tokens of the ``covered`` clips from the resident
        frames (unit rows, so B2 runs with ``normalize=False``): one
        assignment of every row where the clips need at least half of
        them, else of an ``index_select`` of their row ranges."""
        spans = [(y, *manifest[y]) for y in covered]
        need = sum(n for _, _, n in spans)
        if need < frames.shape[0] // 2:
            rows = torch.from_numpy(np.concatenate(
                [np.arange(off, off + n) for _, off, n in spans]))
            frames = frames.index_select(0, rows.to(frames.device))
            starts = np.cumsum([0] + [n for _, _, n in spans[:-1]])
            spans = [(y, int(s), n) for (y, _, n), s in zip(spans, starts)]
        with WIRE.device():  # resident frames: the assignment is device work
            tokens = vq_assign_fused(frames, self.centroids, normalize=False)
            tokens = tokens.cpu().numpy().astype(np.int64)
        WIRE.d2h(tokens)
        return {y: tokens[off : off + n] for y, off, n in spans}

    def _fused_tokens_native(self, ft: FusedTokenizer, chunk: list):
        """The native decode of ``chunk`` ((ytid, path) pairs), one batch of
        ``device_batch_size`` rows straight into the kernel's padded layout
        (int16 under ``pcm_wire="i16"``) -> [(ytid, tokens)] through ``ft``;
        rows the decoder fails (length -1) or with non-finite samples are
        skipped and logged."""
        cfg = self.config
        batch, lengths = native_loader.decode_batch(
            [p for _, p in chunk], cfg.common_sr, cfg.clip_samples,
            cfg.n_fft, n_threads=cfg.num_workers,
            dtype=np.int16 if cfg.pcm_wire == "i16" else np.float32)
        pad_rows = cfg.device_batch_size - len(chunk)
        if pad_rows:  # the batch shape of every other call
            batch = np.pad(batch, ((0, pad_rows), (0, 0)))
            lengths = np.concatenate([lengths,
                                      np.full(pad_rows, -1, np.int32)])
        WIRE.h2d(batch)  # waveforms up, int32 tokens down
        tokens = ft.tokens_from_padded(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(np.maximum(lengths, 0)).to(self.device)
            if cfg.normalize else None).cpu().numpy()
        WIRE.d2h(tokens)
        out = []
        for row, (ytid, path) in enumerate(chunk):
            if lengths[row] < 0:
                logger.info("skipping %s: %s", path,
                            native_loader.last_error())
                continue
            if not np.isfinite(batch[row]).all():
                logger.info("skipping %s: non-finite samples", path)
                continue
            n_valid = num_frames(int(lengths[row]), cfg.hop_length)
            out.append((ytid, tokens[row, :n_valid].astype(np.int64)))
        return out

    def _fused_tokens_python(self, ft: FusedTokenizer, chunk: list):
        """Threaded python decode of ``chunk`` ((ytid, path) pairs) ->
        [(ytid, tokens)] through ``ft`` (B1 on the card); undecodable and
        non-finite clips are skipped, as the staged stage's screens drop
        them."""
        cfg = self.config

        def decode_one(item):
            ytid, path = item
            wave = decode_clip(cfg, path)
            if wave is None:
                return None
            if not np.isfinite(wave).all():
                logger.info("skipping %s: non-finite samples", path)
                return None
            return ytid, wave

        with ThreadPoolExecutor(max_workers=cfg.num_workers) as pool:
            decoded = [d for d in pool.map(decode_one, chunk) if d is not None]
        if not decoded:
            return []
        tokens = ft.tokenize_waveforms([w for _, w in decoded])
        return [(ytid, t) for (ytid, _), t in zip(decoded, tokens)]

    # ------------------------------------------------------------------
    # Reporting (reference :129-240) — computed from per-token counts so
    # host memory stays O(vocab) at corpus scale
    # ------------------------------------------------------------------
    def analyze_token_counts(self, counts: np.ndarray) -> dict:
        present = np.flatnonzero(counts)
        most_tok = int(counts.argmax())
        least_tok = int(present[np.argmin(counts[present])]) if len(present) else None
        stats = {
            "total_tokens": int(counts.sum()),
            "unique_tokens": int(len(present)),
            "most_common": (most_tok, int(counts[most_tok])) if len(present) else None,
            "least_common": (least_tok, int(counts[least_tok]))
            if least_tok is not None else None,
        }
        logger.info("Total tokens: %d", stats["total_tokens"])
        logger.info("Unique tokens: %d", stats["unique_tokens"])
        logger.info("Most common token: %s", stats["most_common"])
        logger.info("Least common token: %s", stats["least_common"])
        zipf = self.analyze_zipf_and_tail(np.sort(counts[present])[::-1])
        stats.update(zipf)
        return stats

    def analyze_tokens(self, all_tokens: np.ndarray) -> dict:
        """Array-based convenience wrapper (small corpora / tests)."""
        return self.analyze_token_counts(
            np.bincount(np.asarray(all_tokens, np.int64), minlength=self.vocab)
        )

    @staticmethod
    def _zipf_fit(frequencies: np.ndarray):
        """Closed-form least squares of log-freq on log-rank over the 10-90%
        rank band (reference used scipy.linregress; same estimator).  The
        SINGLE fit implementation — the reported stats and the plotted line
        both come from here, so they cannot drift."""
        ranks = np.arange(1, len(frequencies) + 1)
        lo, hi = int(0.1 * len(frequencies)), int(0.9 * len(frequencies))
        lx = np.log(ranks[lo:hi])
        ly = np.log(np.asarray(frequencies[lo:hi], np.float64))
        vx = lx - lx.mean()
        slope = float((vx * (ly - ly.mean())).sum() / (vx * vx).sum())
        intercept = float(ly.mean() - slope * lx.mean())
        r = float(
            (vx * (ly - ly.mean())).sum()
            / np.sqrt((vx * vx).sum() * ((ly - ly.mean()) ** 2).sum())
        )
        return slope, intercept, r * r, lx

    def analyze_zipf_and_tail(self, frequencies: np.ndarray) -> dict:
        if len(frequencies) < 4:
            return {"zipf_slope": float("nan"), "tail_start": 0}
        slope, _, r2, _ = self._zipf_fit(frequencies)
        cum = np.cumsum(frequencies) / frequencies.sum()
        tail_start = int(np.searchsorted(cum, 0.8))
        logger.info("Zipf slope: %.2f (r^2=%.2f); 80%% of mass in top %d tokens",
                    slope, r2, tail_start)
        return {"zipf_slope": slope, "zipf_r2": r2, "tail_start": tail_start}

    def plot_token_counts(self, counts: np.ndarray) -> None:
        """Distribution plot, then the Zipf plot; best-effort (a warning
        without matplotlib)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            freqs = np.sort(counts[counts > 0])[::-1]
            ranks = np.arange(1, len(freqs) + 1)
            fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(15, 10))
            ax1.plot(ranks, freqs)
            ax1.set_xscale("log")
            ax1.set_yscale("log")
            ax1.set_title("Distribution of Assigned Tokens (Sorted by Frequency)")
            ax2.bar(ranks[:100], freqs[:100])
            ax2.set_xlabel("Token Rank")
            out = Path(self.config.base_dir) / "output" / "token_distribution.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            fig.tight_layout()
            fig.savefig(out)
            plt.close(fig)
            logger.info("Token distribution plot saved to %s", out)
        except Exception as e:
            logger.warning("token distribution plot failed: %s", e)
        self.plot_zipf(counts)

    def plot_zipf(self, counts: np.ndarray) -> None:
        """Dedicated Zipf figure: log-log rank/frequency scatter + the fitted
        power law over the 10-90% rank band (reference:
        processors/spec_tokenizer.py:211-224)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            freqs = np.sort(counts[counts > 0])[::-1].astype(np.float64)
            if len(freqs) < 4:
                return
            ranks = np.arange(1, len(freqs) + 1)
            slope, intercept, _, lx = self._zipf_fit(freqs)
            fig, ax = plt.subplots(figsize=(10, 6))
            ax.scatter(np.log(ranks), np.log(freqs), s=8, alpha=0.6,
                       label="observed")
            ax.plot(lx, slope * lx + intercept, "r-",
                    label=f"Zipf fit: slope={slope:.2f}")
            ax.set_xlabel("log rank")
            ax.set_ylabel("log frequency")
            ax.set_title("Zipf Analysis of Token Distribution")
            ax.legend()
            out = Path(self.config.base_dir) / "output" / "zipf_analysis.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            fig.tight_layout()
            fig.savefig(out)
            plt.close(fig)
            logger.info("Zipf analysis plot saved to %s", out)
        except Exception as e:
            logger.warning("zipf plot failed: %s", e)


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="default: this rank's card (cuda:0 in one "
                        "process)")
    ns, rest = parser.parse_known_args()
    SpecTokenizer(AudioTokensConfig.from_args(rest), ns.device).run()
