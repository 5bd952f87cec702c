"""Training traffic: device-resident epochs of the default classifier
(``DeviceEpochRunner.train_epoch`` over the ``Trainer``'s step).

The corpus is made from the seed on the card and handed to the runner as
the host arrays a packed corpus is: ``clips`` rows of ``max_seq_len``
uint16 token ids, a ``short_share`` of them cut to a length drawn from
``short_min`` .. ``max_seq_len`` (zero ids past it; the model sees every
position, the reference's all-ones mask, so the work does not depend on
it), and multi-hot labels with 1 .. ``max_positives`` classes a clip.
Weights come from the seed too and are loaded into the Trainer's model
before its optimizer has any state.

Set-up drives the runner through its first ``check_steps`` steps with the
window's own call (``train_epoch`` with ``max_steps``), on the first rows
of epoch 0's permutation, which all differ; a wrapper around the
Trainer's step keeps each step's loss, AdamW's first moment after step 1
(0.1 of the first gradient) and the weights after the last.  The window
then runs whole epochs back to back from epoch 1; at the window's end the
wrapper stops the epoch before its next step is queued, and the card is
synchronized: the steps queued are the steps completed.

``correct`` (after the window): the reference follows the same steps from
the same weights on the same rows (the permutation worked out again from
the seed) in float64, with its own AdamW, and compares each step's loss
(``loss_gap``, relative), the first gradient's norm leaf by leaf
(``grad_gap``, the worst leaf) and the change of each leaf over the steps
(``change_gap``, the median leaf), a leaf's gap of norms taken over the
larger of its reference norm and the median leaf's.  Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import inputs, program
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import lstm as ref_lstm

BETA1 = 0.9


class _Stop(Exception):
    """Raised by the step wrapper once the window's time is up."""


def make_corpus(cfg: dict, mix: dict, seed: int, device: torch.device):
    """-> (tokens (N', T) uint16, lengths (N',) int32, labels (N', C)
    uint8), numpy, made on ``device``; N' rounds the clips up to whole
    batches with zero rows."""
    n, t, c = mix["clips"], cfg["max_seq_len"], cfg["num_classes"]
    gen = inputs.generator(seed, "traffic", device)
    tokens = torch.randint(0, cfg["vocab_size"], (n, t), generator=gen,
                           device=device, dtype=torch.int32)
    lengths = torch.full((n,), t, dtype=torch.int32, device=device)
    short = torch.randperm(n, generator=gen, device=device)[
        :int(mix["short_share"] * n)]
    lengths[short] = torch.randint(mix["short_min"], t + 1, (len(short),),
                                   generator=gen, device=device,
                                   dtype=torch.int32)
    pos = torch.arange(t, device=device)[None, :]
    tokens = torch.where(pos < lengths[:, None], tokens, 0)
    k = torch.randint(1, mix["max_positives"] + 1, (n, 1), generator=gen,
                      device=device)
    order = torch.rand((n, c), generator=gen, device=device).argsort(dim=1)
    labels = torch.zeros((n, c), dtype=torch.uint8, device=device)
    rank = torch.arange(c, device=device)[None, :]
    labels.scatter_(1, order, (rank < k).to(torch.uint8))
    # zero rows up to a whole number of batches, as a packed corpus has
    pad = -n % mix["batch"]
    tokens = torch.nn.functional.pad(tokens, (0, 0, 0, pad))
    lengths = torch.nn.functional.pad(lengths, (0, pad))
    labels = torch.nn.functional.pad(labels, (0, 0, 0, pad))
    return (tokens.to(torch.int64).cpu().numpy().astype(np.uint16),
            lengths.cpu().numpy(), labels.cpu().numpy())


def epoch_rows(n_real: int, seed: int, epoch: int) -> np.ndarray:
    """An epoch's row order: the real rows shuffled by ``seed + epoch``
    (numpy's default generator), as the runner's loader shuffles."""
    order = np.arange(n_real, dtype=np.int64)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: List[str]) -> List[float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(np.median(list(rn.values())))
    return [abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k])
            / max(rn[k], med, 1e-300) for k in names]


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, spans):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans
        self.deadline = None
        self.steps = 0
        self.clips = 0
        self.epoch_start = 0
        self.losses: List[torch.Tensor] = []
        self.first_moment: Dict[str, torch.Tensor] = {}

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from audio_tokens_tpu_torch.train.device_epoch import DeviceEpochRunner
        from audio_tokens_tpu_torch.train.trainer import Trainer

        cfg, mix, dev = self.cfg, self.mix, self.device
        clock = program.Clock()
        self.acfg = program.config(
            cfg, self.seed, training_batch_size=mix["batch"],
            save_best_checkpoint=False, log_every_steps=0)
        self.trainer = Trainer(self.acfg, dev)
        clock.lap("program")
        self.weights = inputs.make_weights(cfg, self.seed, dev)
        self.trainer.model.load_state_dict(self.weights)
        self.corpus = make_corpus(cfg, mix, self.seed, dev)
        self.runner = DeviceEpochRunner(self.trainer)
        self.runner.set_corpus_arrays("train", *self.corpus, mix["clips"],
                                      mix["batch"])
        clock.lap("inputs")
        self._names = {p: n for n, p in self.trainer.model.named_parameters()}
        step = self.trainer._train_step
        self.trainer._train_step = lambda *a: self._step(step, *a)
        self.recording = True
        self.step, _, _ = self.runner.train_epoch(0, 0, mix["check_steps"])
        self.recording = False
        self.after = {n: p.detach().clone()
                      for n, p in self.trainer.model.named_parameters()}
        self.epoch = 1
        self.split = clock.lap("first steps")

    def _step(self, step_fn, inputs_, lengths, labels, row_w, step,
              denom=None):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise _Stop
        with self.spans.span("train_step"):
            loss, probs = step_fn(inputs_, lengths, labels, row_w, step, denom)
        i = step - self.epoch_start
        self.clips += max(0, min(self.mix["batch"],
                                 self.mix["clips"] - i * self.mix["batch"]))
        self.steps += 1
        if self.recording:
            self.losses.append(loss.clone())
            if len(self.losses) == 1:
                opt = self.trainer.optimizer
                # no moment where the optimizer kept no state: a zero
                self.first_moment = {self._names[p]: opt.state[p].get(
                    "exp_avg", torch.zeros_like(p)).clone()
                    for p in self._names}
        return loss, probs

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        start = time.perf_counter()
        self.steps = self.clips = 0
        self.deadline = start + seconds
        try:
            while True:
                self.epoch_start = self.step
                with self.spans.span("train_epoch"):
                    self.step, _, _ = self.runner.train_epoch(self.epoch,
                                                              self.step)
                self.epoch += 1
        except _Stop:
            pass
        finally:
            self.deadline = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"attempted": self.steps, "done": self.steps,
                "clips": self.clips, "seconds": time.perf_counter() - start}

    @staticmethod
    def units(stats: dict) -> int:
        return stats["done"]

    def end_to_end(self, stats: dict) -> Dict[str, float]:
        return {"train_clips_per_s": stats["clips"] / stats["seconds"]}

    def release(self) -> None:
        self.losses = [float(x) for x in self.losses]
        self.first_moment = {k: v.cpu() for k, v in self.first_moment.items()}
        self.after = {k: v.cpu() for k, v in self.after.items()}
        del self.runner, self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct -------------------------------------------------------------
    def reference(self, precision: str = "float64", rows_kept=None,
                  logit_shift: float = 0.0):
        """The reference's first ``check_steps`` steps -> (losses, first
        gradient, weights after).  Planted faults: ``rows_kept`` takes the
        loss over the first rows of each batch only; ``logit_shift`` moves
        the first row's first logit."""
        cfg, mix, dev = self.cfg, self.mix, self.device
        dt = torch.float64 if precision == "float64" else torch.float32
        tokens, _, labels = self.corpus
        order = epoch_rows(mix["clips"], self.acfg.random_seed, 0)
        params = {k: v.to(dt) for k, v in self.weights.items()}
        state: dict = {}
        losses, first = [], None
        b = mix["batch"]
        for s in range(mix["check_steps"]):
            rows = order[s * b:(s + 1) * b][:rows_kept]
            x = torch.from_numpy(tokens[rows].astype(np.int64)).to(dev)
            y = torch.from_numpy(labels[rows]).to(dev).to(dt)
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            z = ref_lstm.logits(x, leaves, cfg["num_layers"], precision)
            if logit_shift:
                shift = torch.zeros_like(z)
                shift[0, 0] = logit_shift
                z = z + shift
            loss = F.binary_cross_entropy_with_logits(z, y)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = grads
            with torch.no_grad():
                params = ref_adamw.step(params, grads, state, s + 1,
                                        cfg["learning_rate"])
        return losses, first, params

    def ref64(self):
        """The float64 reference, computed once a run."""
        if not hasattr(self, "_ref64"):
            self._ref64 = self.reference()
        return self._ref64

    def judge(self, losses, first, after) -> Dict[str, float]:
        r_losses, r_first, r_after = self.ref64()
        grad_norms = {k: float(torch.linalg.vector_norm(v))
                      for k, v in r_first.items()}
        med = float(np.median(list(grad_norms.values())))
        moving = [k for k, g in grad_norms.items() if g >= 1e-3 * med]
        w0 = {k: v.double().cpu() for k, v in self.weights.items()}
        d_prog = {k: after[k].double().cpu() - w0[k] for k in moving}
        d_ref = {k: r_after[k].double().cpu() - w0[k] for k in moving}
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, r_losses)),
            "grad_gap": max(leaf_gaps(first, {k: v.cpu() for k, v in
                                              r_first.items()},
                                      list(r_first))),
            # the median leaf: a small leaf's change swings with the signs
            # of its round-off-sized gradients, which AdamW's first steps
            # turn into whole steps of lr
            "change_gap": float(np.median(leaf_gaps(d_prog, d_ref, moving))),
        }

    def check(self, stats: dict) -> Dict[str, float]:
        grads = {k: v / (1.0 - BETA1) for k, v in self.first_moment.items()}
        return self.judge(self.losses, grads, self.after)

    def control(self) -> Dict[str, float]:
        """The reference one precision step below the configuration's in
        the program's place, judged as the program is."""
        prec = program.STEP_DOWN[self.cfg["precision"]["classifier"]]
        return self.judge(*self.reference(prec))

    def half_batch(self) -> Dict[str, float]:
        """A planted fault: the loss over half of each batch."""
        return self.judge(*self.reference(rows_kept=self.mix["batch"] // 2))

    def altered_logit(self) -> Dict[str, float]:
        """A planted fault: one logit of each step moved by 1."""
        return self.judge(*self.reference(logit_shift=1.0))
