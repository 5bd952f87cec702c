"""Ensembles and learning-rate sweeps: K classifiers of one architecture
trained together over one resident corpus (counterpart of
``audio_tokens_tpu/train/ensemble.py``, single device).

A seed ensemble or an LR sweep is otherwise K runs, each reading the
corpus and paying the whole training time again.  Here the corpus goes to
the card once (``train/device_epoch.py``'s ``_Corpus``) and each step runs
the K members together:

    gather the batch's rows by the epoch's permutation (shared by all)
    forward: torch.func.vmap(functional_call) over the stacked parameters
    backward: one .backward() of the sum of the members' losses
    AdamW over the stacked tensors, each member at its own learning rate

Each parameter is one leaf of shape (K, ...), the member axis first.  The
forward's vmap batches every product over the members; the kernels take
the member axis by their ``torch.library`` vmap rules: B3 launches once a
member (each has its own ``w_hh``), B5 once for all of them (attention has
no weights, so the members fold into its batch).  Autograd records each
member's B3 call with its registered backward, so B4 runs once a member
from the graph.  ``torch.func.grad`` cannot cross those ops (their
autograd registrations are not functorch transforms), which is why the
backward is an ordinary one: the gradients of the summed loss are each
member's own.

Member i is the single ``Trainer`` with ``random_seed=seeds[i]``: its
initial weights come from ``generator_for(seeds[i], "model_init")``, its
dropout masks from its own generator seeded at ``stage_seed(seeds[i],
"dropout") + step`` (through ``models/members.MemberGenerators``), and its
AdamW is the torch formula with the Trainer's constants.  Batch order and
composition come from ``config.random_seed``, as in ``Trainer.run()``, so
a member whose seed and learning rate are the config's follows the single
device-epoch trajectory (``tests/test_torch_ensemble.py``).

An epoch ends with each member's exact macro mAP and the ensemble's
(mean of the members' sigmoids) on the card, all classes of all members in
one sort (``utils/device_metrics.class_ap_device`` over (N, (K + 1) C)),
and one read of 2K + 1 scalars (``device_epoch.read_scalars``); nothing
inside the epoch waits for the card.  ``lstm_remat_chunk`` and
``transformer_remat`` run under the member axis too (the recompute seam,
``models/members.remat``).  Sharding the members over several cards (the
JAX ``mesh`` argument) is ROADMAP A7.5 and refused.

    python -m audio_tokens_tpu_torch.train.ensemble [--device cpu] \\
        --n_models 4 [--seeds 1,2,3,4] [--lrs 1e-4,3e-4,1e-3,3e-3] <config flags>
"""

from __future__ import annotations

import copy
import logging
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call, stack_module_state, vmap

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.models.members import MemberGenerators
from audio_tokens_tpu_torch.train import checkpoint as ckpt
from audio_tokens_tpu_torch.train import device_epoch
from audio_tokens_tpu_torch.train.device_epoch import (_Corpus,
                                                       _feature_dtype,
                                                       corpus_arrays,
                                                       epoch_permutation)
from audio_tokens_tpu_torch.train.objective import model_inputs, weighted_bce
from audio_tokens_tpu_torch.train.trainer import _refuse_unported
from audio_tokens_tpu_torch.utils.device_metrics import (class_ap_device,
                                                         macro_of)
from audio_tokens_tpu_torch.utils.seeding import (generator_for, set_seed,
                                                  stage_seed)

logger = logging.getLogger(__name__)

# the Trainer's AdamW (torch defaults but the weight decay; trainer.py)
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 0.01


class EnsembleTrainer:
    """Train ``n_models`` variants of one architecture together on
    ``device``.

    ``seeds`` vary the initial weights and dropout a member (default:
    ``random_seed + i``); ``learning_rates`` vary AdamW's lr a member
    (default: the config lr for every member).  Batch order and
    composition are shared: they come from ``config.random_seed``.
    """

    RESUME_NAME = "ensemble-resume"

    def __init__(self, config: AudioTokensConfig, device: torch.device | str,
                 n_models: int = 8, seeds: Optional[Sequence[int]] = None,
                 learning_rates: Optional[Sequence[float]] = None,
                 mesh=None):
        if seeds is not None and learning_rates is not None and (
                len(seeds) != len(learning_rates)):
            raise ValueError(
                f"seeds ({len(seeds)}) and learning_rates "
                f"({len(learning_rates)}) must have the same length")
        if seeds is not None:
            n_models = len(seeds)
        elif learning_rates is not None:
            n_models = len(learning_rates)
        if n_models < 1:
            raise ValueError("n_models must be >= 1")
        if mesh is not None:
            raise NotImplementedError(
                "sharding an ensemble's members over several devices is not "
                "ported yet: ROADMAP A7.5")
        if config.model_parallel > 1 or config.sequence_parallel > 1:
            raise ValueError(
                "ensembles assume single-device members (model_parallel = "
                "sequence_parallel = 1); the member axis is the parallel "
                "axis")
        _refuse_unported(config)
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} asked for, but torch "
                               "sees no CUDA device")
        set_seed(config.random_seed)
        self.n_models = n_models
        self.seeds = list(seeds) if seeds is not None else [
            config.random_seed + i for i in range(n_models)]
        self.learning_rates = (
            [float(lr) for lr in learning_rates]
            if learning_rates is not None
            else [config.learning_rate] * n_models)
        self.use_lengths = not config.reference_compat
        self.corpora: Dict[str, _Corpus] = {}
        self._base: Optional[torch.nn.Module] = None
        # the member axis's index (position k is member k) and, with
        # dropout, one generator a member on the device
        self._index = torch.arange(n_models)
        self._dropout_gens = (
            [generator_for(s, "dropout", self.device) for s in self.seeds]
            if config.dropout > 0 else None)
        # AdamW's per-member factors: 1 - lr wd and lr, as the torch
        # formula forms them (in double, rounded to f32 where applied)
        self._decay = torch.tensor(
            [1 - lr * WEIGHT_DECAY for lr in self.learning_rates],
            dtype=torch.float32, device=self.device)
        self._lr = torch.tensor(self.learning_rates, dtype=torch.float64,
                                device=self.device)

    # -- data ------------------------------------------------------------
    def set_corpus_arrays(self, split: str, inputs, lengths, labels,
                          n_real: int, batch_size: int) -> None:
        self.corpora[split] = _Corpus(inputs, lengths, labels, n_real,
                                      batch_size, self.device,
                                      _feature_dtype(self.config))

    def load_corpora(self) -> None:
        """Pack both splits from the pipeline's artifacts (the datasets
        and shapes of the Trainer's device-resident path)."""
        from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator

        cfg = self.config
        train_loader, val_loader = DataLoaderCreator(cfg).get_dataloaders()
        if len(train_loader.ds) == 0:
            raise RuntimeError(
                "no training data found — run the pipeline stages first")
        for split, loader, bs in (
            ("train", train_loader, cfg.training_batch_size),
            ("validation", val_loader, cfg.eval_batch_size),
        ):
            inputs, lengths, labels, n_real = corpus_arrays(
                loader.ds, bs, cfg.max_seq_len)
            logger.info(
                "ensemble corpus %s: %d clips, %.1f MB resident (shared by "
                "all %d members)", split, n_real,
                (inputs.nbytes + labels.nbytes) / 2**20, self.n_models)
            self.set_corpus_arrays(split, inputs, lengths, labels, n_real, bs)

    # -- stacked state ----------------------------------------------------
    def init_state(self):
        """(stacked params, opt_state): member i initialized from
        ``generator_for(seeds[i], 'model_init')``, as a single Trainer with
        ``random_seed=seeds[i]`` (``Trainer._init_state``).  params maps
        each parameter's name to one (K, ...) leaf; opt_state holds AdamW's
        step count and its two moments, stacked alike."""
        models = [get_model(self.config, self.device,
                            generator_for(s, "model_init"))
                  for s in self.seeds]
        params, buffers = stack_module_state(models)
        if buffers:
            raise ValueError(f"members with buffers are not supported: "
                             f"{sorted(buffers)}")
        self._base = copy.deepcopy(models[0]).to("meta")
        del models
        n = sum(p.numel() for p in params.values())
        logger.info("ensemble of %d x %s: %.2fM params each (%.2fM stacked) "
                    "on %s", self.n_models, self.config.model_type,
                    n / self.n_models / 1e6, n / 1e6, self.device)
        opt_state = {
            "step": 0,
            "exp_avg": {k: torch.zeros_like(p) for k, p in params.items()},
            "exp_avg_sq": {k: torch.zeros_like(p) for k, p in params.items()},
        }
        return params, opt_state

    @staticmethod
    def member_params(tree, i: int):
        """Member ``i`` of a stacked tree (params, or opt_state's moments):
        every tensor's slice ``i``, detached; other leaves as they are."""
        if isinstance(tree, dict):
            return {k: EnsembleTrainer.member_params(v, i)
                    for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree[i].detach().clone()
        return tree

    # -- one step ----------------------------------------------------------
    def _forward(self, params, inputs, lengths, labels, row_w, gens):
        """(K,) losses and (K, B, C) logits, the forward vmapped over the
        members."""
        base = self._base

        def member(p, index, x, ln, y, w):
            gen = None if gens is None else MemberGenerators(gens, index)
            logits = functional_call(base, p, (x, ln), {"generator": gen})
            return weighted_bce(logits, y, w), logits

        return vmap(member, in_dims=(0, 0, None, None, None, None))(
            params, self._index, model_inputs(inputs),
            lengths if self.use_lengths else None, labels, row_w)

    @torch.no_grad()
    def _adamw(self, params, opt_state) -> None:
        """One AdamW step over the stacked leaves: ``torch.optim.AdamW``'s
        formula (decoupled decay, bias corrections), member k at lr k, as
        a few ``torch._foreach_*`` calls over all leaves (the per-member
        factors broadcast over each leaf); a member at lr 0 keeps its
        weights bit for bit."""
        opt_state["step"] += 1
        t = opt_state["step"]
        b1, b2 = BETAS
        names = list(params)
        ps = [params[n] for n in names]
        grads = [p.grad for p in ps]
        ms = [opt_state["exp_avg"][n] for n in names]
        vs = [opt_state["exp_avg_sq"][n] for n in names]
        shapes = [(-1,) + (1,) * (p.dim() - 1) for p in ps]
        neg_step = (-(self._lr / (1 - b1 ** t))).float()
        torch._foreach_mul_(ps, [self._decay.view(s) for s in shapes])
        torch._foreach_lerp_(ms, grads, 1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_div_(denom, (1 - b2 ** t) ** 0.5)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_mul(ms, [neg_step.view(s) for s in shapes])
        torch._foreach_div_(update, denom)
        torch._foreach_add_(ps, update)
        for p in ps:
            p.grad = None

    def _step_generators(self, step: int):
        """The members' dropout generators at ``step`` (the single Trainer's
        per-step seed, member by member), or None without dropout."""
        if self._dropout_gens is None:
            return None
        for g, s in zip(self._dropout_gens, self.seeds):
            g.manual_seed(stage_seed(s, "dropout") + step)
        return self._dropout_gens

    def _maps(self, preds, labels, valid):
        """(per-member mAP (K,), ensemble mean-of-sigmoids mAP) from the
        (K, N, C) predictions: the members and their mean fold into the
        class axis, (N, (K + 1) C), one sort for all."""
        k, n, c = preds.shape
        scores = torch.cat([preds, preds.mean(0, keepdim=True)])
        ap, has_pos = class_ap_device(
            scores.permute(1, 0, 2).reshape(n, (k + 1) * c),
            labels.repeat(1, k + 1), valid)
        maps = macro_of(ap.view(k + 1, c), has_pos.view(k + 1, c))
        return maps[:k], maps[k]

    def _read(self, losses, per, ens):
        vals = device_epoch.read_scalars(*losses.unbind(), *per.unbind(), ens)
        k = self.n_models
        return np.asarray(vals[:k]), np.asarray(vals[k:2 * k]), vals[2 * k]

    # -- the epochs ---------------------------------------------------------
    def train_epoch(self, params, opt_state, epoch: int, step: int):
        """One training epoch of every member -> (params, opt_state, step
        after it, losses (K,), mAP (K,), ensemble mAP)."""
        if self._base is None:
            raise RuntimeError("init_state() first")
        c = self.corpora["train"]
        b, n_steps = c.batch_size, c.n_steps
        rows = epoch_permutation(c, self.config.random_seed, epoch,
                                 self.device)
        valid = rows < c.n_real
        preds = torch.empty((self.n_models, n_steps * b,
                             self.config.num_classes), dtype=torch.float32,
                            device=self.device)
        loss_sum = torch.zeros(self.n_models, device=self.device)
        self._base.train()
        for i in range(n_steps):
            sl = slice(i * b, (i + 1) * b)
            idx = rows[sl]
            inputs, lengths, y = (t.index_select(0, idx) for t in (
                c.inputs, c.lengths, c.labels))
            losses, logits = self._forward(params, inputs, lengths, y,
                                           valid[sl].float(),
                                           self._step_generators(step + i))
            losses.sum().backward()
            self._adamw(params, opt_state)
            loss_sum += losses.detach()
            preds[:, sl] = torch.sigmoid(logits.detach())
        per, ens = self._maps(preds, c.labels.index_select(0, rows), valid)
        losses, per, ens = self._read(loss_sum / n_steps, per, ens)
        return params, opt_state, step + n_steps, losses, per, ens

    def eval_epoch(self, params):
        """Every member over the validation split in eval mode under
        ``inference_mode`` -> (losses (K,), mAP (K,), ensemble mAP)."""
        if self._base is None:
            raise RuntimeError("init_state() first")
        c = self.corpora["validation"]
        k, b = self.n_models, c.batch_size
        if c.n_real == 0:
            return np.full(k, np.nan), np.zeros(k), 0.0
        self._base.eval()
        with torch.inference_mode():  # B3 skips its residual stores
            preds = torch.empty((k, c.n_pad, self.config.num_classes),
                                dtype=torch.float32, device=self.device)
            loss_sum = torch.zeros(k, device=self.device)
            for i in range(c.n_steps):
                sl = slice(i * b, (i + 1) * b)
                losses, logits = self._forward(
                    params, c.inputs[sl], c.lengths[sl], c.labels[sl],
                    c.valid[sl].float(), None)
                loss_sum += losses
                preds[:, sl] = torch.sigmoid(logits)
            per, ens = self._maps(preds, c.labels, c.valid)
            return self._read(loss_sum / c.n_steps, per, ens)

    # -- checkpoints ---------------------------------------------------------
    def _member_opt_state(self, opt_state, i: int) -> dict:
        """Member ``i``'s moments as a ``torch.optim.AdamW`` state dict for
        a single model (a Trainer resumes or fine-tunes from it)."""
        names = list(opt_state["exp_avg"])
        shell = torch.optim.AdamW([torch.zeros(0) for _ in names],
                                  lr=self.learning_rates[i], betas=BETAS,
                                  eps=EPS, weight_decay=WEIGHT_DECAY)
        state = shell.state_dict()
        state["state"] = {
            j: {"step": torch.tensor(float(opt_state["step"])),
                "exp_avg": opt_state["exp_avg"][n][i].detach().cpu(),
                "exp_avg_sq": opt_state["exp_avg_sq"][n][i].detach().cpu()}
            for j, n in enumerate(names)}
        return state

    def _save_resume(self, params, opt_state, epoch: int, step: int,
                     best_per, best_ens: float, history) -> None:
        """The stacked params and opt_state and the run's state, atomically:
        a K-member sweep that dies at epoch N-1 resumes exactly instead of
        restarting from zero."""
        ckpt.save_state(
            self.config.checkpoint_dir, self.RESUME_NAME,
            {k: p.detach() for k, p in params.items()}, opt_state,
            step=step, metric=float(np.max(best_per)), epoch=epoch,
            extra=dict(
                seeds=self.seeds, learning_rates=self.learning_rates,
                best_per=np.asarray(best_per, np.float64).tolist(),
                best_ens=float(best_ens), history=history))

    def _restore_resume(self, params, opt_state):
        """Restore a RESUME_NAME checkpoint into the stacked state in place;
        returns (start_epoch, step, best_per, best_ens, history)."""
        cfg = self.config
        name = cfg.resume_from
        meta = ckpt.load_meta(cfg.checkpoint_dir, name)
        if meta.get("seeds") != self.seeds or (
                meta.get("learning_rates") != self.learning_rates):
            raise ValueError(
                f"checkpoint '{name}' was written by an ensemble with "
                f"seeds={meta.get('seeds')} / lrs={meta.get('learning_rates')}"
                f"; this run has seeds={self.seeds} / "
                f"lrs={self.learning_rates} — resuming would silently train "
                "different members")
        saved_p, saved_o, _ = ckpt.load_state(cfg.checkpoint_dir, name)
        if saved_o is None or "exp_avg" not in saved_o:
            raise ValueError(
                f"checkpoint '{name}' has no stacked optimizer state; "
                f"ensemble resume requires the full stacked state (use the "
                f"'{self.RESUME_NAME}' checkpoint, not a best-member export)")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved_p[k])
                for moment in ("exp_avg", "exp_avg_sq"):
                    opt_state[moment][k].copy_(saved_o[moment][k])
        opt_state["step"] = int(saved_o["step"])
        logger.info("ensemble resumed from %s at epoch %d, step %d", name,
                    meta["epoch"], meta["step"])
        return (int(meta["epoch"]), int(meta["step"]),
                np.asarray(meta["best_per"]), float(meta["best_ens"]),
                list(meta["history"]))

    def run(self) -> dict:
        """A whole training run -> the report dict.  Saves the best member
        with its optimizer state as ``ensemble-best`` (when
        ``save_best_checkpoint``) and the stacked state as ``RESUME_NAME``
        after every epoch, under ``checkpoint_dir``."""
        cfg = self.config
        if not self.corpora:
            self.load_corpora()
        params, opt_state = self.init_state()
        best_per = np.full(self.n_models, -1.0)
        best_ens = -1.0
        best_saved = -1.0  # best single-member mAP already checkpointed
        history: List[dict] = []
        step = 0
        start_epoch = 0
        if cfg.resume_from:
            (start_epoch, step, best_per, best_ens,
             history) = self._restore_resume(params, opt_state)
            best_saved = float(np.max(best_per))
        va_ens = float("nan")
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            params, opt_state, step, tr_loss, tr_map, tr_ens = (
                self.train_epoch(params, opt_state, epoch, step))
            va_loss, va_map, va_ens = self.eval_epoch(params)
            best_per = np.maximum(best_per, va_map)
            best_ens = max(best_ens, va_ens)
            history.append(dict(
                epoch=epoch, train_loss=tr_loss.tolist(),
                val_loss=va_loss.tolist(), val_mAP=va_map.tolist(),
                ensemble_val_mAP=va_ens))
            logger.info(
                "epoch %d (%.1fs): val mAP per member [%s], ensemble %.4f",
                epoch, time.time() - t0,
                " ".join(f"{m:.4f}" for m in va_map), va_ens)
            if cfg.save_best_checkpoint:
                # the best member saves WITH its optimizer state at the
                # epoch the improvement happened, so it can be fine-tuned
                i = int(np.argmax(va_map))
                if float(va_map[i]) > best_saved:
                    best_saved = float(va_map[i])
                    ckpt.save_state(
                        cfg.checkpoint_dir, "ensemble-best",
                        self.member_params(params, i),
                        self._member_opt_state(opt_state, i), step=step,
                        metric=best_saved, epoch=epoch + 1,
                        extra=dict(seed=self.seeds[i],
                                   learning_rate=self.learning_rates[i]))
                    logger.info("best member %d (seed %d, lr %g) saved as "
                                "'ensemble-best'", i, self.seeds[i],
                                self.learning_rates[i])
            # the stacked state for an exact resume (epoch + 1: resume
            # continues AFTER this epoch), whatever save_best_checkpoint
            # says: a sweep without best saves must still resume
            self._save_resume(params, opt_state, epoch + 1, step, best_per,
                              best_ens, history)
        if not math.isfinite(va_ens):
            # resumed with an exhausted epoch budget: no training ran;
            # report the restored state's validation numbers, not NaN
            _, _, va_ens = self.eval_epoch(params)
        best_i = int(np.argmax(best_per))
        return dict(
            n_models=self.n_models, seeds=self.seeds,
            learning_rates=self.learning_rates,
            best_member=best_i,
            best_member_val_mAP=float(best_per[best_i]),
            per_member_best_val_mAP=np.asarray(best_per).tolist(),
            ensemble_val_mAP=float(va_ens),
            best_ensemble_val_mAP=float(best_ens),
            history=history,
        )


def main(argv=None) -> dict:
    import argparse

    parser = argparse.ArgumentParser(
        description="Train a seed ensemble / LR sweep over one resident "
                    "corpus, the members' steps vmapped.")
    parser.add_argument("--n_models", type=int, default=8)
    parser.add_argument("--seeds", type=str, default="",
                        help="comma list; default random_seed + i")
    parser.add_argument("--lrs", type=str, default="",
                        help="comma list of learning rates (LR sweep); "
                             "default: the config lr for every member")
    parser.add_argument("--device", default="cuda",
                        help="the device to train on (cpu only when asked)")
    args, rest = parser.parse_known_args(argv)
    config = AudioTokensConfig.from_args(rest)
    seeds = [int(s) for s in args.seeds.split(",") if s] or None
    lrs = [float(s) for s in args.lrs.split(",") if s] or None
    trainer = EnsembleTrainer(config, args.device, n_models=args.n_models,
                              seeds=seeds, learning_rates=lrs)
    report = trainer.run()
    print(f"best member: {report['best_member']} "
          f"(val mAP {report['best_member_val_mAP']:.4f}); "
          f"ensemble val mAP {report['ensemble_val_mAP']:.4f}")
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
