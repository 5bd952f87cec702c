"""Training loop of the port (counterpart of
``audio_tokens_tpu/train/trainer.py``).

Behavioral equivalent of the reference's ModelTrainer (reference:
processors/model_trainer.py:24-204): BCE-with-logits loss, AdamW (b1=0.9
b2=0.999 eps=1e-8 wd=0.01), per-epoch train+val loops accumulating sigmoid
predictions for macro mAP, best-val-mAP checkpointing, optional wandb,
stdlib logging.  As in the JAX trainer:

  * the device is explicit (``Trainer(config, device)``), never guessed;
  * with ``device_corpus`` 'auto' (the default) or 'on', each split's
    corpus goes to the device once and the epochs run there
    (``train/device_epoch.py``: batches gathered on the device, the mAP
    computed there, two scalars read an epoch), where the corpora fit
    ``device_corpus_budget_mb``; 'off', or an over-budget corpus under
    'auto', streams;
  * streamed batches are the copied fixed-shape ``BatchLoader``'s: final partial
    batches are padded and masked via per-row weights, so the loss and the
    metrics match ragged-batch semantics;
  * the step loop never waits for the card: losses accumulate on the device
    and are read once per epoch, and predictions are stacked in windows of
    8 steps whose copy to the host runs on a collector thread;
  * checkpoints carry params, optimizer state, step, metric and epoch for
    exact resume, and early stopping and ``max_train_steps`` are real;
  * ``diagnostics_every`` > 0 writes a gradient-flow report of one batch
    every that many epochs (``utils/diagnostics.py``), under tensor or
    sequence parallelism of the joined weights on one unsharded model
    (``gradient_report``);
  * streamed batches count on the wire meter (``utils/profiling.WIRE``):
    each rank's rows up, the stacked sigmoids down;
  * data parallel across processes (``parallel/``, one card a process)
    when the data group has 2 ranks or more (``data_parallel`` -1, the
    default, takes every rank): the ranks start from rank 0's weights,
    every rank builds the same global batch and keeps its contiguous rows,
    each rank's loss is its rows' share of the global weighted mean (the
    denominator is the global batch's, so a padded last batch weighs as
    in one process), the gradients are summed in one flat all-reduce a
    step, and the predictions are gathered in rank order, so every rank
    computes the same mAP and stops early at the same epoch.  Only rank 0
    writes checkpoints, the metrics history, wandb and diagnostics.

On the card the lstm's recurrence runs kernels B3 (forward, with the
residuals) and B4 (backward), through ``ops/cuda_lstm.lstm_sequence``.  The
bert classifier's training steps take the plain attention route, as the JAX
model's do; its validation passes (eval mode, ``inference_mode``) run kernel
B5 when ``transformer_attention="flash"``.  The simple, cnn and baseline
classifiers train on tokens, ``RawSTFTDataset`` frames and
``RawSTFTFlatDataset`` rows; they have no kernel of their own (a gather,
cuDNN convolutions, cuBLAS products).

Tensor and sequence parallelism (``model_parallel`` > 1,
``sequence_parallel`` > 1; bert only) lay the ranks out on a mesh
(``parallel/mesh.make_mesh(data_parallel, model_parallel,
sequence_parallel)``, ``model`` innermost): every rank builds the model
from one seed, takes rank 0's weights and keeps its slices
(``TransformerClassifier.shard_``); the batch's rows split over the
``data`` axis, the ranks of one data place run the same rows; the
gradients are summed once a step over the mesh's ``replica`` group (data
x sequence, see ``models/transformer.py`` for why that is one process's
gradient); the predictions and losses gather over ``data``.  Epochs
stream (``device_corpus='auto'`` resolves to it, ``'on'`` is refused),
and checkpoints hold one process's layout (the model ranks' slices and
AdamW moments joined), so that one card serves them.  The JAX trainer's
checks stay, with its messages: sequence parallelism is bert's, its
window divides over the sequence ranks, tensor parallelism is bert's (the
lstm's kernels take no model axis, as the JAX Pallas backend), the batch
sizes divide over the data axis.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.data.datasets import BatchLoader, DataLoaderCreator
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.parallel import distributed
from audio_tokens_tpu_torch.parallel.mesh import (DataGroup, Mesh,
                                                  data_group, make_mesh)
from audio_tokens_tpu_torch.train import checkpoint as ckpt
from audio_tokens_tpu_torch.train.device_epoch import (DeviceEpochRunner,
                                                       corpus_nbytes,
                                                       should_materialize)
from audio_tokens_tpu_torch.train.objective import (model_inputs,
                                                    weighted_bce)
from audio_tokens_tpu_torch.utils.metrics import ExactMAP, StreamingMAP
from audio_tokens_tpu_torch.utils.profiling import WIRE, span
from audio_tokens_tpu_torch.utils.seeding import (generator_for, set_seed,
                                                  stage_seed)

logger = logging.getLogger(__name__)


def check_options(config: AudioTokensConfig) -> None:
    """Raise for training options that cannot run together (the JAX
    trainer's checks, with its messages)."""
    if config.device_corpus not in ("auto", "on", "off"):
        raise ValueError(f"device_corpus must be 'auto', 'on' or 'off', "
                         f"got '{config.device_corpus}'")
    if config.model_parallel > 1 and config.model_type == "lstm":
        raise ValueError(
            "the lstm's kernels (B3, B4; lstm_backend='pallas' in the JAX "
            "package) require a DP-only mesh: set model_parallel=1 (TP "
            "applies to model_type='bert' only)")
    if config.sequence_parallel > 1:
        if config.model_type != "bert":
            raise ValueError(
                "sequence_parallel > 1 applies to the transformer only "
                "(model_type='bert')")
        if config.transformer_max_position % config.sequence_parallel:
            raise ValueError(
                f"transformer_max_position "
                f"({config.transformer_max_position}) must be divisible "
                f"by sequence_parallel ({config.sequence_parallel})")
    if config.model_parallel > 1 and config.model_type != "bert":
        raise ValueError(
            "model_parallel > 1 is only meaningful for the transformer "
            "(model_type='bert')")
    if _tensor_or_sequence(config):
        if config.device_corpus == "on":
            raise ValueError(
                "device_corpus='on' is incompatible with model_parallel "
                "or sequence_parallel > 1 (the epoch programs assume a "
                "DP-only mesh); set device_corpus='off' or a DP-only mesh")


def _tensor_or_sequence(config: AudioTokensConfig) -> bool:
    return config.model_parallel > 1 or config.sequence_parallel > 1


def mesh_for(config: AudioTokensConfig) -> Optional[Mesh]:
    """The (data, sequence, model) mesh of a tensor- or sequence-parallel
    run (the JAX ``Trainer._init_state``'s), None otherwise; the batch
    sizes must divide over its data axis."""
    if not _tensor_or_sequence(config):
        return None
    mesh = make_mesh(data=config.data_parallel, model=config.model_parallel,
                     seq=config.sequence_parallel)
    n = mesh.data.size
    if config.training_batch_size % n or config.eval_batch_size % n:
        # the user explicitly asked for TP/SP; silently dropping it
        # would change memory/placement intent — fail loudly instead
        raise ValueError(
            f"batch sizes ({config.training_batch_size} train / "
            f"{config.eval_batch_size} eval) must be divisible by the "
            f"data axis ({n}) when model_parallel="
            f"{config.model_parallel} / sequence_parallel="
            f"{config.sequence_parallel} is requested")
    return mesh


class _AsyncCollector:
    """Single worker thread that copies stacked prediction windows to the
    host and folds them into the mAP accumulator, so the step loop keeps
    queueing work while a window's copy waits for the card."""

    def __init__(self, acc):
        self.acc = acc
        self._q = queue.Queue(maxsize=2)
        self._exc = None

        def work():
            while True:
                item = self._q.get()
                if item is None:
                    return
                try:
                    stacked, metas = item
                    arrs = stacked.cpu().numpy()
                    for (labels, n), parr in zip(metas, arrs):
                        self.acc.update(labels[:n], parr[:n])
                except BaseException as e:  # surfaced at join()
                    self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def submit(self, stacked, metas):
        if self._exc is not None:
            raise self._exc
        self._q.put((stacked, metas))

    def join(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc


class _LossMean:
    """Running mean of per-step loss scalars: accumulate ON THE DEVICE (one
    small add per step), read ONCE at epoch end."""

    def __init__(self):
        self._sum = None
        self._n = 0

    def add(self, loss: torch.Tensor) -> None:
        self._sum = loss if self._sum is None else self._sum + loss
        self._n += 1

    def result(self, dp: Optional[DataGroup] = None) -> float:
        """The mean; under data parallelism each rank holds its rows'
        share of every step's loss, summed over the data ranks here."""
        if self._n == 0:
            return float("nan")
        if dp is not None:
            dp.all_reduce_(self._sum)
        return float(self._sum) / self._n


class Trainer:
    _PENDING_FLUSH = 8  # prediction windows: one stack + copy per 8 steps

    def __init__(self, config: AudioTokensConfig,
                 device: Optional[torch.device | str] = None):
        """``device`` None: this rank's card under ``distributed``, else
        ``cuda:0`` (``parallel/distributed.default_device``)."""
        self.config = config
        check_options(config)
        distributed.maybe_initialize(config)
        self.device = (distributed.default_device() if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} asked for, but torch "
                               "sees no CUDA device")
        set_seed(config.random_seed)
        self.use_lengths = not config.reference_compat
        self.run_name = self._initialize_wandb()
        self.mesh = mesh_for(config)
        self.model, self.optimizer = self._init_state()
        if self.mesh is not None:
            self.dp, self.grad_group = self.mesh.data, self.mesh.replica
        else:
            self.dp = self.grad_group = self._data_group()
            if self.dp is not None:  # every rank starts from rank 0's weights
                self.dp.broadcast_(self.model.state_dict().values())
        self._dropout_gen = (generator_for(config.random_seed, "dropout",
                                           self.device)
                             if config.dropout > 0 else None)

    # ------------------------------------------------------------------
    def run(self) -> Tuple[float, Dict[str, float]]:
        cfg = self.config
        train_loader, val_loader = DataLoaderCreator(cfg).get_dataloaders()
        if len(train_loader.ds) == 0:
            raise RuntimeError("no training data found — run the pipeline stages first")
        runner = self._maybe_device_runner(train_loader, val_loader)
        if runner is not None:
            def train_epoch(epoch, step):
                return runner.train_epoch(epoch, step, cfg.max_train_steps)

            eval_epoch = runner.eval_epoch
        else:
            def train_epoch(epoch, step):
                return self._train_epoch(train_loader, epoch, step)

            def eval_epoch():
                return self._eval_epoch(val_loader)

        # seeded BELOW any real mAP so the first epoch always checkpoints
        best_metric = -1.0
        epochs_since_best = 0
        step = 0
        start_epoch = 0
        if cfg.resume_from:
            distributed.barrier("resume")  # every rank reads rank 0's file
            has_opt, step, best_metric, start_epoch = self._load(
                cfg.resume_from)
            if not has_opt:
                logger.warning(
                    "checkpoint %s has no optimizer state; starting the "
                    "optimizer fresh", cfg.resume_from)
            # the epoch counter resumes too: epoch drives the shuffle
            # permutations (seed+epoch) and the remaining-epoch budget
            logger.info("resumed from %s at step %d, epoch %d (best mAP %.4f)",
                        cfg.resume_from, step, start_epoch, best_metric)
            if start_epoch >= cfg.epochs:
                logger.warning(
                    "checkpoint is already at epoch %d >= epochs=%d — "
                    "nothing to train (raise epochs to continue)",
                    start_epoch, cfg.epochs)
        val_loss, val_metrics = float("nan"), {"mAP": 0.0}

        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            step, train_loss, train_metrics = train_epoch(epoch, step)
            val_loss, val_metrics = eval_epoch()
            # on a mesh every rank joins the weights; else the coordinator
            if (cfg.diagnostics_every and epoch % cfg.diagnostics_every == 0
                    and (self.mesh is not None
                         or distributed.is_coordinator())):
                self._run_diagnostics(train_loader, epoch)
            self._log_epoch_results(epoch, train_loss, train_metrics,
                                    val_loss, val_metrics, time.time() - t0)

            if val_metrics["mAP"] > best_metric:
                logger.info("val mAP of %.4f > %.4f. Saving model.",
                            val_metrics["mAP"], best_metric)
                best_metric = val_metrics["mAP"]
                epochs_since_best = 0
                if cfg.save_best_checkpoint:
                    self._save(f"{self.run_name}-best", step, best_metric,
                               epoch + 1)  # resume continues AFTER this epoch
            else:
                epochs_since_best += 1

            if (cfg.early_stopping_patience
                    and epochs_since_best >= cfg.early_stopping_patience):
                logger.info("early stopping at epoch %d", epoch)
                break
            if cfg.max_train_steps and step >= cfg.max_train_steps:
                logger.info("reached max_train_steps=%d", cfg.max_train_steps)
                break

        if not math.isfinite(val_loss) and start_epoch >= cfg.epochs:
            # resumed with an exhausted epoch budget: report the restored
            # checkpoint's validation numbers instead of NaN
            val_loss, val_metrics = eval_epoch()
        return val_loss, val_metrics

    # ------------------------------------------------------------------
    def evaluate(self, checkpoint_name: Optional[str] = None
                 ) -> Tuple[float, Dict[str, float]]:
        """Evaluate a saved checkpoint on the validation split (no
        training)."""
        cfg = self.config
        if checkpoint_name is None:
            if cfg.use_wandb:
                raise ValueError(
                    "with use_wandb=True each run gets a fresh name — pass the "
                    "training run's checkpoint name to evaluate() explicitly")
            checkpoint_name = f"{self.run_name}-best"
        train_loader, val_loader = DataLoaderCreator(cfg).get_dataloaders()
        params, _, _ = ckpt.load_state(cfg.checkpoint_dir, checkpoint_name)
        self._load_params(params)
        runner = self._maybe_device_runner(train_loader, val_loader,
                                           eval_only=True)
        if runner is not None:
            val_loss, val_metrics = runner.eval_epoch()
        else:
            val_loss, val_metrics = self._eval_epoch(val_loader)
        logger.info("Eval: loss %.4f, mAP %.4f", val_loss, val_metrics["mAP"])
        return val_loss, val_metrics

    # ------------------------------------------------------------------
    def _maybe_device_runner(self, train_loader: BatchLoader,
                             val_loader: BatchLoader, eval_only: bool = False):
        """The device-resident epoch runner (``train/device_epoch.py``)
        when ``device_corpus`` asks for it and the corpora fit
        ``device_corpus_budget_mb``; None to stream (``'off'``, an
        over-budget corpus under ``'auto'``).  ``eval_only`` makes only the validation corpus resident
        (``evaluate``)."""
        cfg = self.config
        if cfg.device_corpus == "off" or self.mesh is not None:
            return None  # a tensor- or sequence-parallel run streams
        wanted = ((val_loader, cfg.eval_batch_size),) if eval_only else (
            (train_loader, cfg.training_batch_size),
            (val_loader, cfg.eval_batch_size))
        feat_itemsize = 2 if cfg.device_corpus_dtype == "bfloat16" else 4

        def estimate(map_bins):
            return sum(
                corpus_nbytes(len(loader.ds), bs, cfg.max_seq_len,
                              cfg.n_mels, loader.ds.kind, cfg.num_classes,
                              cfg.vocab_size, feat_itemsize, map_bins)
                for loader, bs in wanted)

        est = estimate(cfg.device_map_bins)
        budget = cfg.device_corpus_budget_mb * 2**20
        if est > budget:
            msg = ("device corpus %s: estimated %.0f MB exceeds "
                   "device_corpus_budget_mb=%d")
            if cfg.device_corpus == "on":  # forced: proceed, but say so
                logger.warning(msg + " (forced on)", "over budget",
                               est / 2**20, cfg.device_corpus_budget_mb)
            else:
                # map_bins=1: the corpus bytes alone; if THAT fits, the
                # exact metric's prediction buffer blew the budget and the
                # histogram metric is the fix
                if cfg.device_map_bins == 0 and estimate(1) <= budget:
                    logger.info(
                        "device corpus disabled by the exact epoch-mAP "
                        "buffer, not the corpus: set device_map_bins "
                        "(e.g. 8192) to train device-resident")
                logger.info(msg + "; streaming batches instead", "disabled",
                            est / 2**20, cfg.device_corpus_budget_mb)
                return None
        # the epoch gather (train split only): one transient permuted copy
        # of the training inputs; see config.device_epoch_gather
        materialize = False
        if not eval_only:
            kind = train_loader.ds.kind
            materialize, copy_bytes = should_materialize(
                cfg, kind, len(train_loader.ds), feat_itemsize, est, budget)
            if materialize and est + copy_bytes > budget:
                logger.warning(
                    "device_epoch_gather='epoch': permuted-corpus copy "
                    "(%.0f MB) pushes the estimate over the budget "
                    "(forced on)", copy_bytes / 2**20)
            elif (not materialize and cfg.device_epoch_gather == "auto"
                  and kind in ("spec", "flat")):
                logger.info(
                    "device epoch: permuted-corpus copy (%.0f MB) over "
                    "budget; keeping per-step gathers", copy_bytes / 2**20)
        runner = DeviceEpochRunner(self, materialize_train=materialize)
        if not eval_only:
            runner.set_corpus("train", train_loader.ds,
                              cfg.training_batch_size, cfg.max_seq_len)
        runner.set_corpus("validation", val_loader.ds, cfg.eval_batch_size,
                          cfg.max_seq_len)
        return runner

    # ------------------------------------------------------------------
    def _init_state(self) -> Tuple[torch.nn.Module, torch.optim.Optimizer]:
        """The model and its AdamW; on a mesh, rank 0's weights on every
        rank, sharded (the optimizer holds this rank's slices)."""
        cfg = self.config
        model = get_model(cfg, self.device,
                          generator_for(cfg.random_seed, "model_init"))
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("model %s: %.2fM params on %s", cfg.model_type,
                    n_params / 1e6, self.device)
        if self.mesh is not None:
            DataGroup().broadcast_(model.state_dict().values())
            model.shard_(self.mesh)
            logger.info(
                "mesh %s (this rank data %d, sequence %d, model %d): %.2fM "
                "params on this rank", self.mesh.shape, self.mesh.data.rank,
                self.mesh.sequence.rank, self.mesh.model.rank,
                sum(p.numel() for p in model.parameters()) / 1e6)
        optimizer = torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=0.01)
        return model, optimizer

    def _data_group(self) -> Optional[DataGroup]:
        """The data group (``parallel/mesh.data_group``), or None where
        the batch sizes do not split evenly over it (then every rank
        trains on whole batches, as the JAX trainer falls back to one
        device)."""
        cfg = self.config
        dp = data_group(cfg)
        if dp is not None and (cfg.training_batch_size % dp.size
                               or cfg.eval_batch_size % dp.size):
            logger.warning(
                "batch sizes %d/%d not divisible by %d ranks; training "
                "without data parallelism", cfg.training_batch_size,
                cfg.eval_batch_size, dp.size)
            return None
        if dp is not None:
            logger.info("data parallel over %d ranks (this rank %d), "
                        "%d rows a rank a step", dp.size, dp.rank,
                        cfg.training_batch_size // dp.size)
        return dp

    def _put_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of the batch on the device: inputs, lengths,
        labels (shipped as uint8, multi-hot 0/1, exact) and row weights
        (all rows without data parallelism), and the loss's denominator:
        None in one process, under data parallelism the whole batch's, from
        its row weights as ``weighted_bce`` forms it.  On a card the host
        arrays are pinned first, so the copies are asynchronous and the
        step loop does not wait for the previous step."""
        row_w = (np.arange(len(batch["lengths"])) < batch["n_valid"]).astype(
            np.float32)
        host = (batch["inputs"], batch["lengths"],
                np.asarray(batch["labels"], np.uint8), row_w)
        lo, hi = (0, len(row_w)) if self.dp is None else \
            self.dp.row_bounds(len(row_w))
        host = tuple(a[lo:hi] for a in host[:3]) + (row_w,)
        WIRE.h2d(*host)  # this rank's rows (and the whole row weights)
        out = []
        for arr in host:
            t = torch.from_numpy(arr)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        inputs, lengths, labels, row_w = out
        denom = None
        if self.dp is not None:
            denom = torch.clamp(row_w.sum() * self.config.num_classes,
                                min=1.0)
        return inputs, lengths, labels.float(), row_w[lo:hi], denom

    def _save(self, name: str, step: int, metric: float, epoch: int) -> None:
        """Rank 0 writes the checkpoint ``name`` in one process's layout;
        under tensor parallelism every rank first joins its slices of the
        weights and the AdamW moments (a collective)."""
        params, opt_state = self.model.state_dict(), self.optimizer.state_dict()
        if self._tensor_parallel:
            params = self.model.full_state_dict()
            opt_state = self._moments(opt_state, join=True)
        if distributed.is_coordinator():
            ckpt.save_state(self.config.checkpoint_dir, name, params,
                            opt_state, step, metric, epoch)

    @property
    def _tensor_parallel(self) -> bool:
        return self.mesh is not None and self.mesh.model.size > 1

    def _load_params(self, params: dict) -> None:
        if self.mesh is None:
            self.model.load_state_dict(params)
        else:
            self.model.load_full_state_dict(params)

    def _load(self, name: str) -> Tuple[bool, int, float, int]:
        """Restore checkpoint ``name`` (one process's layout) into this
        rank's model and optimizer -> (whether it had optimizer state,
        step, metric, epoch)."""
        params, opt_state, meta = ckpt.load_state(self.config.checkpoint_dir,
                                                  name)
        self._load_params(params)
        if opt_state is not None:
            if self._tensor_parallel:
                opt_state = self._moments(opt_state, join=False)
            self.optimizer.load_state_dict(opt_state)
        return (opt_state is not None, meta["step"], meta["metric"],
                int(meta.get("epoch", 0)))

    def _moments(self, state: dict, join: bool) -> dict:
        """An AdamW ``state_dict`` with the moments of the tensor-parallel
        parameters joined over the model ranks (``join``, a collective) or
        cut to this rank's slices, along the parameter's dimension."""
        axis = self.mesh.model
        names = [n for n, _ in self.model.named_parameters()]
        out = {"param_groups": state["param_groups"], "state": {}}
        for i, moments in state["state"].items():
            dim = self.model.tp_specs[names[int(i)]]
            if dim is not None:
                moments = {k: v if k == "step"
                           else axis.all_gather(v, dim) if join
                           else v.chunk(axis.size, dim)[axis.rank].clone()
                           for k, v in moments.items()}
            out["state"][i] = moments
        return out

    def _metric_accumulator(self):
        """Exact mAP by default (reference semantics); constant-memory
        histogram mAP when config.streaming_map_bins > 0 (corpus scale)."""
        if self.config.streaming_map_bins > 0:
            return StreamingMAP(self.config.num_classes,
                                bins=self.config.streaming_map_bins)
        return ExactMAP()

    def _flush_pending(self, pending, collector):
        if not pending:
            return
        stacked = torch.stack([p for _, p, _ in pending])
        if self.dp is not None:  # the whole batches' rows, in rank order
            stacked = self.dp.all_gather(stacked, dim=1)
        WIRE.d2h(stacked)  # per-batch sigmoids: the streaming loop's d2h
        metas = [(labels, n) for labels, _, n in pending]
        pending.clear()
        collector.submit(stacked, metas)

    def _logits(self, inputs, lengths, step: Optional[int] = None):
        gen = None
        if step is not None and self._dropout_gen is not None:
            # one stream per step, as the JAX trainer folds the step into
            # its dropout key: a resumed run draws what a straight run does
            gen = self._dropout_gen.manual_seed(
                stage_seed(self.config.random_seed, "dropout") + step)
        return self.model(model_inputs(inputs),
                          lengths if self.use_lengths else None,
                          generator=gen)

    def _train_step(self, inputs, lengths, labels, row_w, step: int,
                    denom=None):
        """One AdamW step -> (loss, probabilities).  Under data
        parallelism ``denom`` is the global batch's denominator: the loss
        is this rank's share of the global mean, and the gradients are
        summed over the ranks before the update."""
        with span("train.forward"):
            logits = self._logits(inputs, lengths, step)
            loss = weighted_bce(logits, labels, row_w, denom)
        with span("train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.grad_group is not None:
                self.grad_group.all_reduce_grads(self.model.parameters())
        with span("train.optimizer"):
            self.optimizer.step()
        return loss.detach(), torch.sigmoid(logits.detach())

    def _train_epoch(self, loader: BatchLoader, epoch: int, step: int):
        cfg = self.config
        self.model.train()
        losses = _LossMean()
        pending = []
        acc = self._metric_accumulator()
        collector = _AsyncCollector(acc)
        try:
            for batch in loader.batches(epoch):
                # budget check BEFORE the update: resuming a checkpoint
                # saved exactly at the cap must not train one extra step
                if cfg.max_train_steps and step >= cfg.max_train_steps:
                    break
                *rows, denom = self._put_batch(batch)
                loss, p = self._train_step(*rows, step, denom)
                losses.add(loss)  # device-resident running sum
                pending.append((batch["labels"], p, batch["n_valid"]))
                if len(pending) >= self._PENDING_FLUSH:
                    self._flush_pending(pending, collector)
                step += 1
                if cfg.log_every_steps and step % cfg.log_every_steps == 0:
                    # progress only — reading the loss here would wait for
                    # the card every N steps
                    logger.info("epoch %d: step %d", epoch, step)
                if cfg.max_train_steps and step >= cfg.max_train_steps:
                    break
            self._flush_pending(pending, collector)
        finally:
            collector.join()
        return step, losses.result(self.dp), acc.result()

    def _eval_epoch(self, loader: BatchLoader):
        self.model.eval()
        losses = _LossMean()
        pending = []
        acc = self._metric_accumulator()
        collector = _AsyncCollector(acc)
        try:
            with torch.inference_mode():  # B3 skips its residual stores
                for batch in loader.batches(0):
                    inputs, lengths, labels, row_w, denom = \
                        self._put_batch(batch)
                    logits = self._logits(inputs, lengths)
                    losses.add(weighted_bce(logits, labels, row_w, denom))
                    pending.append((batch["labels"], torch.sigmoid(logits),
                                    batch["n_valid"]))
                    if len(pending) >= self._PENDING_FLUSH:
                        self._flush_pending(pending, collector)
                self._flush_pending(pending, collector)
        finally:
            collector.join()
        return losses.result(self.dp), acc.result()

    # ------------------------------------------------------------------
    def _run_diagnostics(self, loader: BatchLoader, epoch: int
                         ) -> Optional[dict]:
        """Gradient-flow report on the epoch's first batch, with a bar chart
        ``{run_name}-gradflow-e{epoch}.png`` beside the checkpoints (the
        reference wired this hook but left it disabled — reference:
        processors/model_trainer.py:56-58) -> the report (None on a rank
        other than the coordinator)."""
        batches = loader.batches(epoch)
        try:
            batch = next(batches)
        finally:
            batches.close()  # reaps the producer
        plot = (Path(self.config.checkpoint_dir)
                / f"{self.run_name}-gradflow-e{epoch}.png")
        return self.gradient_report(batch, plot)

    def gradient_report(self, batch: dict, plot_path: Optional[Path] = None
                        ) -> Optional[dict]:
        """``utils/diagnostics.gradient_flow`` of the model on ``batch``.
        On a tensor- or sequence-parallel mesh every rank joins the weights
        (``full_state_dict``, a collective: every rank calls this) and the
        coordinator reports on one unsharded model over the whole window,
        as a one-host JAX mesh does; the other ranks return None."""
        from audio_tokens_tpu_torch.utils.diagnostics import (gradient_flow,
                                                              make_batch_loss)

        model = self.model
        if self.mesh is not None:
            state = model.full_state_dict()
            if not distributed.is_coordinator():
                return None
            model = get_model(self.config, self.device,
                              generator_for(self.config.random_seed,
                                            "model_init"))
            model.load_state_dict(state)
        loss_fn = make_batch_loss(model, batch, self.use_lengths, self.device)
        return gradient_flow(loss_fn, dict(model.named_parameters()),
                             plot_path=plot_path)

    # ------------------------------------------------------------------
    def _log_epoch_results(self, epoch, train_loss, train_metrics, val_loss,
                           val_metrics, seconds):
        logger.info("Epoch %d (%.1fs)", epoch, seconds)
        logger.info("Train Loss: %.4f, Train mAP: %.4f", train_loss,
                    train_metrics["mAP"])
        logger.info("Val Loss: %.4f, Val mAP: %.4f", val_loss,
                    val_metrics["mAP"])
        if not distributed.is_coordinator():
            return  # the history and wandb are single-writer artifacts
        record = {
            "epoch": epoch,
            "train_loss": train_loss,
            "train_mAP": train_metrics["mAP"],
            "val_loss": val_loss,
            "val_mAP": val_metrics["mAP"],
        }
        # durable metrics history next to the checkpoints (wandb-independent)
        try:
            metrics_path = (Path(self.config.checkpoint_dir)
                            / f"{self.run_name}-metrics.jsonl")
            metrics_path.parent.mkdir(parents=True, exist_ok=True)
            with metrics_path.open("a") as f:
                f.write(json.dumps({**record,
                                    "seconds": round(seconds, 2)}) + "\n")
        except OSError as e:
            logger.warning("could not append metrics history: %s", e)
        if self._wandb is not None:
            self._wandb.log(record)

    def _initialize_wandb(self) -> str:
        self._wandb = None
        if self.config.use_wandb and distributed.is_coordinator():
            try:
                import wandb

                run = wandb.init(project=self.config.wandb_project,
                                 config=self.config.to_dict())
                self._wandb = wandb
                return run.name
            except Exception as e:
                logger.warning("wandb unavailable (%s); continuing without", e)
        return "no-wandb"
