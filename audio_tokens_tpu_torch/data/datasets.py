"""Host-side datasets + fixed-shape batching for training.

A copy of ``audio_tokens_tpu/data/datasets.py`` (held equal by
``tests/test_torch_train_data.py``: byte-equal batches in the same order).
Under multi-process runs (``parallel/distributed.py``) the training-input
cache is built by the coordinator alone, and every rank waits at a barrier
for it, also after a failed build.

Equivalents of the reference's three torch Datasets + collate functions
(reference: datasets/tokenized_spec_dataset.py, datasets/raw_stft_dataset.py,
datasets/raw_stft_flat_dataset.py) rebuilt for XLA's static-shape world:

  * the reference pads each batch to the *batch* max length; here every batch
    is padded to ``config.max_seq_len`` so one compiled program serves the
    whole run (10 s clips are ~constant-length anyway: 1723 frames);
  * pad value is 0 — in ``reference_compat`` mode that includes the token/pad
    collision and all-ones masks of SURVEY.md §2.7.1-2; with
    ``reference_compat=False`` true lengths are carried and consumed by the
    models;
  * the final partial batch is padded to full batch size with ``n_valid``
    marking real rows (losses/metrics are masked accordingly).

``dataset_type`` strings match the reference: TokenizedSpecDataset,
RawSTFTDataset, RawSTFTFlatDataset.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)


class ClipDataset:
    """Base: a split's clips as (feature array path, multi-hot labels).

    Subclasses that define ``_cache_dtype``/``_cache_encode``/``_cache_decode``
    get a consolidated memory-mapped training-input cache: all clips' feature
    arrays packed once into one flat binary + offsets, so per-clip loads are
    zero-copy slices instead of np.load file opens (measured 12x loader
    throughput on one core).  Staleness-checked against per-clip artifact
    mtimes and the clip set; disabled via ``config.token_cache`` (the
    per-ytid .npy artifacts are unchanged — they remain the stage
    contract)."""

    #: subclasses set: directory holding per-ytid .npy files + feature kind
    kind: str = "tokens"  # 'tokens' | 'spec' | 'flat'
    _cache_dtype = None  # set by subclasses that support the flat cache

    def __init__(
        self,
        config: AudioTokensConfig,
        metadata: AudiosetMetadataProcessor,
        split: str = "train",
    ):
        self.config = config
        self.metadata = metadata
        self.split = split
        with open(config.split_file, "r") as f:
            split_ytids = json.load(f)[split]
        base = self._base_path()
        self.files: List[Path] = []
        self.ytids: List[str] = []
        for ytid in split_ytids:
            p = base / f"{ytid}.npy"
            if p.exists():  # skip clips whose artifact is missing (reference :40-47)
                self.files.append(p)
                self.ytids.append(ytid)
        if len(self.files) < len(split_ytids):
            logger.info(
                "%s/%s: %d of %d clips have artifacts",
                type(self).__name__, split, len(self.files), len(split_ytids),
            )
        self._cache = None
        self._offsets = None
        if (getattr(config, "token_cache", True) and self.files
                and self._cache_dtype is not None and self._cache_enabled()):
            try:
                self._open_or_build_cache()
            except Exception as e:  # the cache is an optimization, never fatal
                logger.warning("training-input cache disabled: %s", e)
                self._cache = None

    # -- flat-cache hooks -------------------------------------------------
    def _cache_enabled(self) -> bool:
        return True

    def _cache_encode(self, raw: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _cache_decode(self, flat: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _cache_paths(self):
        base = self._base_path().parent
        return (base / f"{self.split}.{self.kind}cache.bin",
                base / f"{self.split}.{self.kind}cache.idx.npz")

    def _open_or_build_cache(self) -> None:
        bin_f, idx_f = self._cache_paths()

        def valid() -> bool:
            try:
                if not (bin_f.exists() and idx_f.exists()):
                    return False
                idx = np.load(idx_f, allow_pickle=False)
                if list(idx["ytids"]) != self.ytids:  # '<U..' string array
                    return False
                # bind the cache to its SOURCE DIRECTORY and the files'
                # EXACT identity (mtime_ns + size).  The old `mtime <=
                # cache mtime` test missed content swapped in with OLDER
                # timestamps (a restored backup, a re-pointed sibling dir,
                # an extracted tar) — the cache would silently serve the
                # previous corpus.  Pre-round-4 caches lack these keys ->
                # rebuild.
                if ("base" not in idx.files or "mtimes" not in idx.files
                        or str(idx["base"]) != str(self._base_path())):
                    return False
                stats = [p.stat() for p in self.files]
                return (
                    np.array_equal(idx["mtimes"],
                                   [s.st_mtime_ns for s in stats])
                    and np.array_equal(idx["sizes"],
                                       [s.st_size for s in stats]))
            except Exception as e:  # corrupt idx etc. -> rebuild, never raise
                logger.warning("training-input cache invalid (%s); rebuilding", e)
                return False

        # The STALE files are removed before building — a skipped or failed
        # build must leave nothing behind, or the open below would happily
        # memmap an outdated corpus.
        # The build runs under try so that the barrier below is reached on
        # every path: a coordinator failure must not leave the other ranks
        # waiting in it.
        if distributed.is_coordinator() and not valid():
            for p in (bin_f, idx_f):
                try:
                    p.unlink()
                except OSError:
                    pass
            try:
                self._build_cache(bin_f, idx_f)
            except Exception as e:
                logger.warning("training-input cache build failed: %s", e)
                for p in (bin_f, idx_f):  # no partial artifacts for others
                    try:
                        p.unlink()
                    except OSError:
                        pass
        distributed.barrier(f"{self.kind}cache-{self.split}")
        if not (bin_f.exists() and idx_f.exists()):
            logger.info("%s/%s: no training-input cache; using per-file loads",
                        type(self).__name__, self.split)
            return  # self._cache stays None
        idx = np.load(idx_f, allow_pickle=False)
        if list(idx["ytids"]) != self.ytids:
            logger.warning("training-input cache clip set mismatch; "
                           "using per-file loads")
            return
        self._offsets = idx["offsets"]
        self._cache = np.memmap(bin_f, dtype=self._cache_dtype, mode="r")

    def _build_cache(self, bin_f: Path, idx_f: Path) -> None:
        """Stream-encode every clip into one flat binary.

        Chunks go straight to a temp file (``arr.tofile``) so host RAM stays
        one clip deep regardless of corpus size, and construction is skipped
        (or aborted) when the encoded corpus would exceed
        ``config.input_cache_budget_mb`` — the float32 spectrogram cache of a
        2M-clip corpus is hundreds of GB and must never be attempted."""
        import io
        import os

        from audio_tokens_tpu_torch.utils.npy_io import atomic_save_bytes

        budget_mb = getattr(self.config, "input_cache_budget_mb", 8192)
        budget = budget_mb * 2**20 if budget_mb else None
        itemsize = np.dtype(self._cache_dtype).itemsize
        if not self.files:
            return  # empty split: per-file loads are trivially correct
        # cheap upfront estimate: first clip's encoded size x clip count
        # (10 s clips are near-uniform length); the running total below is
        # the hard stop for corpora with uneven clips
        first = np.ascontiguousarray(
            self._cache_encode(np.load(self.files[0])), self._cache_dtype)
        est = first.size * itemsize * len(self.files)
        if budget is not None and est > budget:
            logger.info(
                "training-input cache skipped: estimated %.0f MB exceeds "
                "input_cache_budget_mb=%d", est / 2**20, budget_mb)
            return
        offsets = np.zeros(len(self.files) + 1, np.int64)
        tmp = bin_f.with_name(bin_f.name + f".tmp.{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                for i, p in enumerate(self.files):
                    enc = first if i == 0 else np.ascontiguousarray(
                        self._cache_encode(np.load(p)), self._cache_dtype)
                    enc.tofile(f)
                    offsets[i + 1] = offsets[i] + enc.size
                    if budget is not None and offsets[i + 1] * itemsize > budget:
                        raise RuntimeError(
                            f"encoded corpus exceeds input_cache_budget_mb="
                            f"{budget_mb} at clip {i + 1}/{len(self.files)}")
            os.replace(tmp, bin_f)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        buf = io.BytesIO()
        stats = [p.stat() for p in self.files]
        np.savez(buf, offsets=offsets, ytids=np.asarray(self.ytids),
                 base=np.asarray(str(self._base_path())),
                 mtimes=np.asarray([s.st_mtime_ns for s in stats], np.int64),
                 sizes=np.asarray([s.st_size for s in stats], np.int64))
        atomic_save_bytes(idx_f, buf.getvalue())
        logger.info("training-input cache built: %s (%d clips, %.1f MB)",
                    bin_f, len(self.files),
                    offsets[-1] * itemsize / 2**20)

    # ---------------------------------------------------------------------
    def _base_path(self) -> Path:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.files)

    def labels_for(self, idx: int) -> np.ndarray:
        return self.metadata.multi_hot(self.ytids[idx], self.config.num_classes)

    def load_features(self, idx: int) -> np.ndarray:
        if self._cache is not None:
            lo, hi = self._offsets[idx], self._offsets[idx + 1]
            return self._cache_decode(self._cache[lo:hi])
        return self._load_file(self.files[idx])

    def _load_file(self, path: Path) -> np.ndarray:
        raise NotImplementedError


class TokenizedSpecDataset(ClipDataset):
    kind = "tokens"
    _cache_dtype = np.uint16

    def _cache_enabled(self) -> bool:
        return self.config.vocab_size <= 65535  # token IDs must fit uint16

    def _cache_encode(self, raw: np.ndarray) -> np.ndarray:
        return raw.astype(np.uint16)

    def _cache_decode(self, flat: np.ndarray) -> np.ndarray:
        return np.asarray(flat, np.int32)

    def _base_path(self) -> Path:
        # The reference's dataset reads config.tokenized_train_dir /
        # tokenized_val_dir (datasets/tokenized_spec_dataset.py:33-38), which
        # default to {dest_tokenized_path}/{split} but are independently
        # overridable — honor them the same way.
        override = (self.config.tokenized_train_dir if self.split == "train"
                    else self.config.tokenized_val_dir)
        if override:
            return Path(override)
        return Path(self.config.dest_tokenized_path) / self.split

    def _load_file(self, path: Path) -> np.ndarray:
        return np.load(path).astype(np.int32)


class RawSTFTDataset(ClipDataset):
    kind = "spec"
    _cache_dtype = np.float32

    def _cache_encode(self, raw: np.ndarray) -> np.ndarray:
        return raw.astype(np.float32).ravel()  # (n_mels, T) row-major

    def _cache_decode(self, flat: np.ndarray) -> np.ndarray:
        m = self.config.n_mels
        return np.ascontiguousarray(
            np.asarray(flat, np.float32).reshape(m, -1).T)  # (T, n_mels)

    def _base_path(self) -> Path:
        return Path(self.config.source_spec_path) / self.split

    def _load_file(self, path: Path) -> np.ndarray:
        return np.load(path).T.astype(np.float32)  # (T, n_mels)


class RawSTFTFlatDataset(RawSTFTDataset):
    kind = "flat"

    def _cache_paths(self):  # shares the spec cache (same encoded bytes)
        base = self._base_path().parent
        return (base / f"{self.split}.speccache.bin",
                base / f"{self.split}.speccache.idx.npz")


def pack_features_row(feats: np.ndarray, kind: str, out_row: np.ndarray,
                      t: int, n_mels: int) -> int:
    """Write one clip's features into a preallocated fixed-shape row;
    returns the true (pre-padding) length.  The ONE implementation of the
    truncate/pad/flatten semantics, shared by BatchLoader batch assembly and
    the device-resident corpus packer (train/device_epoch.py) so the
    streaming and device training paths can never drift."""
    n = min(len(feats), t)
    if kind == "flat":  # zero-pad then flatten (reference raw_stft_flat :58-69)
        buf = np.zeros((t, n_mels), np.float32)
        buf[:n] = feats[:n]
        out_row[:] = buf.reshape(-1)
    else:  # tokens / spec: left-aligned rows, zero tail
        out_row[:n] = feats[:n]
    return n


_DATASET_TYPES = {
    "TokenizedSpecDataset": TokenizedSpecDataset,
    "RawSTFTDataset": RawSTFTDataset,
    "RawSTFTFlatDataset": RawSTFTFlatDataset,
}


def get_dataset_class(config: AudioTokensConfig):
    try:
        return _DATASET_TYPES[config.dataset_type]
    except KeyError:
        raise ValueError(f"Unsupported dataset type: {config.dataset_type}") from None


class BatchLoader:
    """Fixed-shape batches with seeded shuffling and background prefetch.

    Yields dicts:
      inputs   (B, ...)  int32 tokens / float32 spec / float32 flat
      lengths  (B,)      true pre-padding lengths (frames or tokens)
      labels   (B, C)    multi-hot float32
      n_valid  int       number of real rows in this batch (rest are padding)
    """

    def __init__(
        self,
        dataset: ClipDataset,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        max_seq_len: Optional[int] = None,
        prefetch: int = 2,
        num_workers: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.max_seq_len = max_seq_len or dataset.config.max_seq_len
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.n_mels = dataset.config.n_mels

    def __len__(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def _make_batch(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        bs, T = self.batch_size, self.max_seq_len
        kind = self.ds.kind
        cfg = self.ds.config
        if kind == "tokens":
            inputs = np.zeros((bs, T), np.int32)
        else:
            inputs = np.zeros(
                (bs, T * self.n_mels) if kind == "flat" else (bs, T, self.n_mels),
                np.float32,
            )
        lengths = np.zeros((bs,), np.int32)
        labels = np.zeros((bs, cfg.num_classes), np.float32)
        for row, idx in enumerate(idxs):
            feats = self.ds.load_features(int(idx))
            lengths[row] = pack_features_row(feats, kind, inputs[row], T,
                                             self.n_mels)
            labels[row] = self.ds.labels_for(int(idx))
        return {
            "inputs": inputs,
            "lengths": lengths,
            "labels": labels,
            "n_valid": len(idxs),
        }

    def dummy_batch(self) -> Dict[str, np.ndarray]:
        """A zero batch with this loader's exact shapes/dtypes (for model
        init / shape inference without spinning up the producer thread)."""
        return self._make_batch(np.zeros((0,), np.int64))

    def _index_batches(self, epoch: int) -> Iterator[np.ndarray]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            yield order[i : i + self.batch_size]

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Background batch assembly overlapping the training step.

        ``num_workers > 1`` assembles batches in a thread pool with ordered
        reassembly (the reference used 8 DataLoader worker processes,
        reference: datasets/data_loader_creator.py:24; np.load releases the
        GIL during file reads so threads scale on real hosts).  Batch order,
        error propagation and early-abandon cleanup are identical to the
        single-producer path.
        """
        if self.num_workers > 1:
            yield from self._batches_parallel(epoch)
            return
        yield from self._batches_single(epoch)

    def _batches_parallel(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        window = self.num_workers + self.prefetch  # bounds host memory
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        inflight: deque = deque()
        it = self._index_batches(epoch)
        try:
            for idxs in it:
                inflight.append(ex.submit(self._make_batch, idxs))
                if len(inflight) >= window:
                    break
            while inflight:
                item = inflight.popleft().result()  # re-raises worker errors
                nxt = next(it, None)
                if nxt is not None:
                    inflight.append(ex.submit(self._make_batch, nxt))
                yield item
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _batches_single(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """One producer thread (double buffering) via the shared
        ``BoundedProducer`` (utils/worker.py — the single owner of the
        bounded producer/cancel/exception-forwarding pattern): producer
        errors re-raise in the consumer instead of silently truncating the
        epoch; abandoning the generator early reaps the thread."""
        from audio_tokens_tpu_torch.utils.worker import BoundedProducer

        producer = BoundedProducer(
            (self._make_batch(idxs) for idxs in self._index_batches(epoch)),
            depth=self.prefetch,
        )
        try:
            yield from producer
        finally:
            producer.close()


class DataLoaderCreator:
    """Reference-shaped factory (datasets/data_loader_creator.py:17-53)."""

    def __init__(self, config: AudioTokensConfig):
        self.config = config

    def get_dataloaders(self) -> Tuple[BatchLoader, BatchLoader]:
        cls = get_dataset_class(self.config)
        metadata = AudiosetMetadataProcessor(self.config)
        train = cls(self.config, metadata, split="train")
        val = cls(self.config, metadata, split="validation")
        train_loader = BatchLoader(
            train, self.config.training_batch_size, shuffle=True,
            seed=self.config.random_seed,
            num_workers=self.config.num_workers,
        )
        val_loader = BatchLoader(
            val, self.config.eval_batch_size, shuffle=False,
            seed=self.config.random_seed,
            num_workers=self.config.num_workers,
        )
        return train_loader, val_loader
