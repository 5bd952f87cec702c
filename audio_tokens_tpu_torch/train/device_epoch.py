"""Device-resident training epochs (counterpart of
``audio_tokens_tpu/train/device_epoch.py``, its single-device part).

The streaming Trainer ships every batch over the host link each epoch and
copies every batch's sigmoids back for mAP.  A balanced-corpus token epoch
is ~76 MB of uint16: it fits on the card many times over.  So each split's
corpus goes to the card once, and an epoch runs as

    for each step:
        gather the batch's rows by the epoch's permutation (on the card)
        loss, backward, AdamW update       (the Trainer's own step)
        write the sigmoids into the epoch's buffer (or its histogram)
    macro mAP of the epoch on the card (utils/device_metrics.py)

with no host -> card copy inside the step loop (the permutation goes over
once an epoch), no card -> host read and no synchronize in it, and one
read of two scalars (loss, mAP) at the epoch's end (``read_scalars``).
Where the JAX package compiles the epoch into one program, the port
queues its steps from Python: the card runs them back to back while the
host queues ahead.

Batch composition, shuffle order (the seeded permutation of
``BatchLoader``), padded-row weighting, the loss and the per-step dropout
generator are the streaming path's, so the trajectories agree
(``tests/test_torch_device_epoch.py``).  Residency is gated by
``device_corpus_budget_mb`` with the JAX package's estimate
(``corpus_nbytes``), so ``'auto'`` decides as it does.  Data-parallel
epochs (the JAX ``shard_map`` branch) are ROADMAP A7.4.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.data.datasets import pack_features_row
from audio_tokens_tpu_torch.train.objective import weighted_bce
from audio_tokens_tpu_torch.utils.device_metrics import (
    binned_map_init, binned_map_result, binned_map_update, macro_map_device)

logger = logging.getLogger(__name__)


def _feature_dtype(cfg) -> torch.dtype:
    """The resident dtype of spec/flat corpus rows
    (``config.device_corpus_dtype``)."""
    want = cfg.device_corpus_dtype
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if want not in dtypes:
        raise ValueError(f"device_corpus_dtype must be 'float32' or "
                         f"'bfloat16', got '{want}'")
    return dtypes[want]


def corpus_arrays(ds, batch_size: int, max_seq_len: int):
    """Pack a ClipDataset split into fixed-shape host arrays -> (inputs,
    lengths int32, labels uint8, n_real).

    Rows are padded to a whole number of batches so every step has the full
    batch shape; ``n_real`` marks the real rows (pad rows weigh 0 in the
    loss and are excluded from mAP exactly).  Tokens pack as uint16 where
    the vocabulary fits (cast back in the loss), features as float32 (the
    card's copy takes ``device_corpus_dtype``).
    """
    cfg = ds.config
    n = len(ds)
    n_pad = -(-n // batch_size) * batch_size
    t, m = max_seq_len, cfg.n_mels
    if ds.kind == "tokens":
        dtype = np.uint16 if cfg.vocab_size <= 0xFFFF else np.int32
        inputs = np.zeros((n_pad, t), dtype)
    elif ds.kind == "spec":
        inputs = np.zeros((n_pad, t, m), np.float32)
    else:  # flat
        inputs = np.zeros((n_pad, t * m), np.float32)
    lengths = np.zeros(n_pad, np.int32)
    labels = np.zeros((n_pad, cfg.num_classes), np.uint8)

    def pack_row(i: int) -> None:
        feats = ds.load_features(i)
        lengths[i] = pack_features_row(feats, ds.kind, inputs[i], t, m)
        labels[i] = ds.labels_for(i)

    workers = max(1, cfg.num_workers)
    if workers > 1 and n > 1:
        # the one-time pack is disk-bound at real scale: the streaming
        # loader's worker budget, rows written to disjoint slices
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for _ in pool.map(pack_row, range(n)):
                pass
    else:
        for i in range(n):
            pack_row(i)
    return inputs, lengths, labels, n


def row_nbytes(max_seq_len: int, n_mels: int, kind: str, vocab_size: int,
               feat_itemsize: int = 4) -> int:
    """Bytes of one resident corpus row (for the budget estimates)."""
    if kind == "tokens":
        return max_seq_len * (2 if vocab_size <= 0xFFFF else 4)
    return max_seq_len * n_mels * feat_itemsize


def should_materialize(cfg, kind: str, n_clips: int,
                       feat_itemsize: int = 4, est: int = 0,
                       budget: Optional[int] = None) -> Tuple[bool, int]:
    """The ``device_epoch_gather`` policy -> (materialize, copy_bytes):
    'epoch' forces the per-epoch permuted copy of the training inputs,
    'auto' takes it for wide-row kinds (spec/flat) where the copy fits what
    is left of the budget (``budget=None``: unbounded), token kinds keep
    the per-step gathers."""
    gmode = cfg.device_epoch_gather
    n_pad = (-(-max(n_clips, 1) // cfg.training_batch_size)
             * cfg.training_batch_size)
    copy_bytes = n_pad * row_nbytes(cfg.max_seq_len, cfg.n_mels, kind,
                                    cfg.vocab_size, feat_itemsize)
    if gmode == "epoch":
        return True, copy_bytes
    if gmode == "auto" and kind in ("spec", "flat"):
        fits = budget is None or est + copy_bytes <= budget
        return fits, copy_bytes
    return False, copy_bytes


def corpus_nbytes(n_clips: int, batch_size: int, max_seq_len: int,
                  n_mels: int, kind: str, num_classes: int,
                  vocab_size: int, feat_itemsize: int = 4,
                  map_bins: int = 0) -> int:
    """Device-memory estimate of one resident split: corpus + labels +
    lengths + the epoch's metric state, an (n_pad, C) f32 prediction buffer
    and the exact metric's sort copies (4 n_pad C 4 bytes, map_bins 0), or
    the (2, C, bins) int32 histogram of the binned metric."""
    n_pad = -(-max(n_clips, 1) // batch_size) * batch_size
    row = row_nbytes(max_seq_len, n_mels, kind, vocab_size, feat_itemsize)
    if map_bins > 0:
        metric = 2 * num_classes * map_bins * 4
    else:
        metric = 4 * n_pad * num_classes * 4
    return n_pad * (row + num_classes + 4) + metric


def read_scalars(*values: torch.Tensor) -> List[float]:
    """The one card -> host read of an epoch: the 0-dim ``values`` stacked
    and copied at once (the tests count the reads by wrapping it)."""
    return torch.stack(values).tolist()


def epoch_permutation(c: "_Corpus", seed: int, epoch: int,
                      device: torch.device) -> torch.Tensor:
    """The epoch's row order on ``device`` (``BatchLoader._index_batches``'s
    RNG): the real rows shuffled by ``seed + epoch``, then the pad rows."""
    order = np.arange(c.n_real, dtype=np.int64)
    np.random.default_rng(seed + epoch).shuffle(order)
    perm = torch.from_numpy(np.concatenate([order,
                                            np.arange(c.n_real, c.n_pad)]))
    if device.type == "cuda":  # an asynchronous copy: no sync
        return perm.pin_memory().to(device, non_blocking=True)
    return perm


class _Corpus:
    def __init__(self, inputs: np.ndarray, lengths: np.ndarray,
                 labels: np.ndarray, n_real: int, batch_size: int,
                 device: torch.device, feature_dtype: torch.dtype):
        x = torch.from_numpy(inputs)
        if x.is_floating_point():
            x = x.to(feature_dtype)  # rounded on the host: half the copy
        self.inputs = x.to(device)
        self.lengths = torch.from_numpy(lengths).to(device)
        self.labels = torch.from_numpy(labels).to(device)
        self.n_real = int(n_real)
        self.n_pad = int(inputs.shape[0])
        self.batch_size = int(batch_size)
        self.n_steps = self.n_pad // self.batch_size
        self.valid = torch.arange(self.n_pad, device=device) < self.n_real


class DeviceEpochRunner:
    """The resident corpora of one ``Trainer`` and its epochs on them.

    Each step is the trainer's own (``Trainer._train_step`` and, in eval,
    ``Trainer._logits``), on batches gathered on the card.
    ``materialize_train=True`` gathers the permuted training corpus once at
    the top of each epoch and takes contiguous slices of it, in place of a
    gather of ``batch_size`` rows a step: the same batch values, at the cost
    of one transient corpus-sized copy, which the Trainer budgets for.
    """

    def __init__(self, trainer, materialize_train: bool = False):
        self.trainer = trainer
        self.config = trainer.config
        self.device = trainer.device
        self.materialize_train = materialize_train
        self.corpora: Dict[str, _Corpus] = {}

    # -- corpus residency ------------------------------------------------
    def set_corpus_arrays(self, split: str, inputs, lengths, labels,
                          n_real: int, batch_size: int) -> None:
        self.corpora[split] = _Corpus(inputs, lengths, labels, n_real,
                                      batch_size, self.device,
                                      _feature_dtype(self.config))

    def set_corpus(self, split: str, ds, batch_size: int,
                   max_seq_len: int) -> None:
        inputs, lengths, labels, n_real = corpus_arrays(ds, batch_size,
                                                        max_seq_len)
        self.set_corpus_arrays(split, inputs, lengths, labels, n_real,
                               batch_size)
        c = self.corpora[split]
        logger.info(
            "device corpus %s: %d clips (%d padded), %.1f MB resident",
            split, n_real, c.n_pad,
            sum(t.numel() * t.element_size()
                for t in (c.inputs, c.lengths, c.labels)) / 2**20)

    def _metric(self, n_rows: int):
        """-> (add(i, probs, labels, valid), result()) over an epoch of
        ``n_rows`` rows: the exact metric's prediction buffer, or the
        histogram when ``device_map_bins`` > 0."""
        cfg = self.config
        if cfg.device_map_bins > 0:
            hist = binned_map_init(cfg.num_classes, cfg.device_map_bins,
                                   self.device)
            return (lambda i, p, y, v: binned_map_update(hist, p, y, v),
                    lambda y, v: binned_map_result(hist))
        preds = torch.empty((n_rows, cfg.num_classes), dtype=torch.float32,
                            device=self.device)

        def add(i, p, y, v):
            b = p.shape[0]
            preds[i * b:(i + 1) * b] = p

        return add, lambda y, v: macro_map_device(preds, y, v)

    # -- the epochs ---------------------------------------------------------
    def train_epoch(self, epoch: int, step: int, max_steps: int = 0
                    ) -> Tuple[int, float, Dict[str, float]]:
        """One training epoch (at most ``max_steps - step`` steps when
        ``max_steps``) -> (step after it, mean loss, {"mAP"})."""
        c = self.corpora["train"]
        n_steps = c.n_steps
        if max_steps:
            n_steps = min(n_steps, max_steps - step)
        if n_steps <= 0:
            return step, float("nan"), {"mAP": 0.0}
        b = c.batch_size
        rows = epoch_permutation(c, self.config.random_seed, epoch,
                                 self.device)[:n_steps * b]
        valid = rows < c.n_real
        if self.materialize_train:
            src = [t.index_select(0, rows)
                   for t in (c.inputs, c.lengths, c.labels)]
            labels = src[2]
        else:
            labels = c.labels.index_select(0, rows)
        add, result = self._metric(n_steps * b)
        self.trainer.model.train()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(n_steps):
            sl = slice(i * b, (i + 1) * b)
            if self.materialize_train:
                inputs, lengths, y = (t[sl] for t in src)
            else:
                idx = rows[sl]
                inputs, lengths, y = (t.index_select(0, idx) for t in (
                    c.inputs, c.lengths, c.labels))
            row_w = valid[sl].float()
            loss, probs = self.trainer._train_step(inputs, lengths, y, row_w,
                                                   step + i)
            loss_sum += loss
            add(i, probs, y, row_w)
        loss, m = read_scalars(loss_sum / n_steps, result(labels, valid))
        return step + n_steps, loss, {"mAP": m}

    def eval_epoch(self) -> Tuple[float, Dict[str, float]]:
        """The validation epoch over contiguous slices, in eval mode under
        ``inference_mode`` -> (mean loss, {"mAP"})."""
        c = self.corpora["validation"]
        if c.n_real == 0:
            return float("nan"), {"mAP": 0.0}
        b = c.batch_size
        add, result = self._metric(c.n_pad)
        self.trainer.model.eval()
        with torch.inference_mode():  # B3 skips its residual stores
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            for i in range(c.n_steps):
                sl = slice(i * b, (i + 1) * b)
                y, row_w = c.labels[sl], c.valid[sl].float()
                logits = self.trainer._logits(c.inputs[sl], c.lengths[sl])
                loss_sum += weighted_bce(logits, y, row_w)
                add(i, torch.sigmoid(logits), y, row_w)
            loss, m = read_scalars(loss_sum / c.n_steps,
                                   result(c.labels, c.valid))
        return loss, {"mAP": m}
