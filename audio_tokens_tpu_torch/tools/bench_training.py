"""Training step-rate benchmark: the whole train step (forward, backward,
AdamW) a model family at configurable shapes, and the loops around it
(counterpart of ``audio_tokens_tpu/tools/bench_training.py``).

Timing: steps are chained through the parameters, N steps are queued and
one synchronize ends them (in-order execution on the card's stream), the
host clock around it.  Rates are against the H100 SXM's dense peak for the
case's arithmetic (989 TFLOP/s bf16, 67 TFLOP/s f32 FMA: the lstm and
simple families compute in f32, bert, cnn and baseline at their
``compute_dtype``).  Everything runs on ``--device`` (default ``cuda``;
the CPU only when asked).

Usage: python -m audio_tokens_tpu_torch.tools.bench_training
       [--models simple,bert,lstm] [--iters 20] [--forward] [--real-loop]
       [--device-loop] [--ensemble K] [--epochs 3] [--batches 32]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model, model_input_kind
from audio_tokens_tpu_torch.utils.seeding import generator_for

# (case name, model_type, batch, seq, config overrides)
DEFAULT_CASES = [
    ("simple", "simple", 64, 1728, dict(hidden_size=768)),
    ("bert", "bert", 32, 512, dict(hidden_size=768, num_layers=2, dropout=0.0)),
    # full-clip attention (transformer_max_position = the whole 10 s clip),
    # ~11x the 512-window attention FLOPs, so the batch drops to 8
    ("bert_full", "bert", 8, 1728, dict(hidden_size=768, num_layers=2,
                                        dropout=0.0,
                                        transformer_max_position=1728)),
    ("lstm", "lstm", 64, 1728, dict(lstm_embed_dim=256, lstm_hidden_dim=512,
                                    num_layers=1)),
    # spec-input families at the reference's full-clip spectrogram shape
    ("cnn", "cnn", 64, 1728, dict()),
    ("baseline", "baseline", 64, 1728, dict()),
    # bf16 storage of the resident spec corpus (device_corpus_dtype)
    ("baseline_bf16", "baseline", 64, 1728,
     dict(device_corpus_dtype="bfloat16")),
    ("cnn_bf16", "cnn", 64, 1728, dict(device_corpus_dtype="bfloat16")),
]

# H100 SXM dense peaks at 700 W (NVIDIA data sheet), FLOP/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def case_config(model_type: str, seq: int, **overrides) -> AudioTokensConfig:
    """The benchmark's configuration: vocab 500, 543 classes, ``seq``."""
    kwargs = dict(model_type=model_type, vocab_size=500, num_classes=543,
                  max_seq_len=seq)
    kwargs.update(overrides)
    return AudioTokensConfig(**kwargs)


def _bench_inputs(cfg, batch: int, seq: int, rng) -> np.ndarray:
    """Synthetic inputs of what the family consumes (``model_input_kind``)."""
    kind = model_input_kind(cfg)
    if kind == "tokens":
        return rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    if kind == "spec":
        return rng.standard_normal((batch, seq, cfg.n_mels)).astype(
            np.float32)
    return rng.standard_normal((batch, seq * cfg.n_mels)).astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_flops(model_type, cfg, batch, seq):
    """Train-step GEMM FLOPs (forward + ~2x backward); None for families
    whose cost is gathers and pools rather than products."""
    if model_type == "lstm":
        e, h = cfg.lstm_embed_dim, cfg.lstm_hidden_dim
        # layer 0 consumes the embedding (E wide); deeper layers consume the
        # bidirectional concat (2H wide)
        per_tok = 2.0 * (e * 4 * h + h * 4 * h) * 2  # both directions, fwd
        per_tok += (cfg.num_layers - 1) * 2.0 * (2 * h * 4 * h + h * 4 * h) * 2
        return 3.0 * per_tok * batch * seq
    if model_type == "bert":
        hs = cfg.hidden_size
        # the model truncates to its attention window (512 = reference)
        t = min(seq, cfg.transformer_max_position)
        per_tok_layer = 2.0 * 12 * hs * hs  # qkv/proj + 4x MLP, fwd
        attn = 4.0 * t * t * hs  # scores + weighted sum, fwd
        return 3.0 * (per_tok_layer * t + attn) * cfg.num_layers * batch
    if model_type == "cnn":
        t, m = seq, cfg.n_mels
        conv1 = 2.0 * t * m * 9 * 1 * 32
        conv2 = 2.0 * (t // 2) * (m // 2) * 9 * 32 * 64
        fc = 2.0 * ((t // 4) * (m // 4) * 64 * 256 + 256 * cfg.num_classes)
        return 3.0 * (conv1 + conv2 + fc) * batch
    if model_type == "baseline":
        d = seq * cfg.n_mels
        return 3.0 * 2.0 * (d * 512 + 512 * 256 + 256 * cfg.num_classes) * batch
    return None


def peak_flops(cfg) -> float:
    """The card's dense peak for the family's arithmetic: f32 for the
    lstm (B3, B4 and its products) and simple, ``compute_dtype`` else."""
    if cfg.model_type in ("lstm", "simple"):
        return PEAK_FLOPS["float32"]
    return PEAK_FLOPS[cfg.compute_dtype]


def bench_case(model_type: str, batch: int, seq: int, iters: int,
               device="cuda", **overrides) -> float:
    """ms a chained train step (loss, backward, AdamW) on one batch."""
    device = torch.device(device)
    cfg = case_config(model_type, seq, **overrides)
    model = get_model(cfg, device, generator_for(0, "bench"))
    model.train()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_bench_inputs(cfg, batch, seq, rng)).to(device)
    y = torch.from_numpy((rng.random((batch, cfg.num_classes)) < 0.05)
                         .astype(np.float32)).to(device)
    gen = (generator_for(0, "dropout", device) if cfg.dropout > 0
           else None)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                  weight_decay=0.01)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = F.binary_cross_entropy_with_logits(
            model(x, None, generator=gen), y)
        loss.backward()
        optimizer.step()
        return loss

    t0 = time.perf_counter()
    step()
    _sync(device)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    flops = _train_flops(model_type, cfg, batch, seq)
    perf = ""
    if flops:
        rate = flops / (ms / 1e3)
        perf = (f" (~{rate / 1e12:.1f} TFLOP/s, ~{rate / peak_flops(cfg):.0%}"
                f" of the card's peak)")
    print(f"{model_type:8s} B={batch} T={seq}: first step {warm_s:5.1f}s, "
          f"{ms:7.1f} ms/step -> {batch / ms * 1000:8.0f} clips/s{perf}")
    return ms


def bench_forward_case(model_type: str, batch: int, seq: int, iters: int,
                       device="cuda", **overrides) -> float:
    """ms an eval-mode forward (the validation and serving path, where
    bert's ``flash`` attention runs B5)."""
    device = torch.device(device)
    cfg = case_config(model_type, seq, **overrides)
    model = get_model(cfg, device, generator_for(0, "bench")).eval()
    x = torch.from_numpy(_bench_inputs(cfg, batch, seq,
                                       np.random.default_rng(0))).to(device)
    with torch.inference_mode():
        model(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        _sync(device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"{model_type:8s} B={batch} T={seq} forward: {ms:7.2f} ms/batch "
          f"-> {batch / ms * 1000:8.0f} clips/s")
    return ms


class _MemLoader:
    """A ``BatchLoader``-shaped wrapper over batches made in memory: the
    Trainer loop's own cost (copies, the dropout seed, the prediction
    windows) without the disk and batch assembly."""

    def __init__(self, batches):
        self._batches = batches
        self.ds = batches  # the len(ds) > 0 check only

    def batches(self, epoch: int):
        yield from self._batches


def synthetic_corpus(cfg, batch: int, n: int, rng):
    """A resident corpus of ``n`` rows as ``device_epoch.corpus_arrays``
    packs one -> (inputs, lengths, labels): uint16 tokens or f32 rows,
    full lengths, ~5% positive labels."""
    seq = cfg.max_seq_len
    inputs = _bench_inputs(cfg, n, seq, rng)
    if model_input_kind(cfg) == "tokens":
        inputs = inputs.astype(np.uint16)
    lengths = np.full(n, seq, np.int32)
    labels = (rng.random((n, cfg.num_classes)) < 0.05).astype(np.uint8)
    return inputs, lengths, labels


def _loop_config(model_type, batch, seq, overrides):
    kwargs = dict(training_batch_size=batch, dropout=0.0,
                  save_best_checkpoint=False, log_every_steps=0)
    kwargs.update(overrides)
    return case_config(model_type, seq, **kwargs)


def bench_real_loop(model_type: str, batch: int, seq: int, epochs: int,
                    n_batches: int, device="cuda", **overrides) -> float:
    """ms a step of the streaming ``Trainer._train_epoch`` loop (the
    ``device_corpus="off"`` path) on batches in memory."""
    from audio_tokens_tpu_torch.train.trainer import Trainer

    cfg = _loop_config(model_type, batch, seq, overrides)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(n_batches):
        inputs, lengths, labels = synthetic_corpus(cfg, batch, batch, rng)
        batches.append({"inputs": inputs.astype(np.int32)
                        if inputs.dtype == np.uint16 else inputs,
                        "lengths": lengths,
                        "labels": labels.astype(np.float32),
                        "n_valid": batch})
    loader = _MemLoader(batches)
    trainer = Trainer(cfg, device)
    step, _, _ = trainer._train_epoch(loader, 0, 0)  # warm-up
    t0 = time.perf_counter()
    for e in range(1, epochs + 1):
        step, _, _ = trainer._train_epoch(loader, e, step)
    dt = time.perf_counter() - t0
    ms = dt / (n_batches * epochs) * 1e3
    print(f"{model_type:8s} B={batch} T={seq}: real Trainer._train_epoch loop "
          f"{ms:7.1f} ms/step -> {batch * n_batches * epochs / dt:8.0f} "
          f"clips/s (incl. the copies, the epoch mAP)")
    return ms


def bench_device_loop(model_type: str, batch: int, seq: int, epochs: int,
                      n_batches: int, device="cuda", **overrides) -> float:
    """ms a step of the device-resident epoch (``train/device_epoch.py``):
    the corpus on the card, the mAP there, two scalars read an epoch."""
    from audio_tokens_tpu_torch.train.device_epoch import (DeviceEpochRunner,
                                                           should_materialize)
    from audio_tokens_tpu_torch.train.trainer import Trainer

    cfg = _loop_config(model_type, batch, seq, overrides)
    n = batch * n_batches
    arrays = synthetic_corpus(cfg, batch, n, np.random.default_rng(0))
    trainer = Trainer(cfg, device)
    materialize, _ = should_materialize(cfg, model_input_kind(cfg), n)
    runner = DeviceEpochRunner(trainer, materialize_train=materialize)
    runner.set_corpus_arrays("train", *arrays, n, batch)
    t0 = time.perf_counter()
    step, _, _ = runner.train_epoch(0, 0)  # warm-up
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for e in range(1, epochs + 1):
        step, _, _ = runner.train_epoch(e, step)
    dt = time.perf_counter() - t0
    ms = dt / (n_batches * epochs) * 1e3
    print(f"{model_type:8s} B={batch} T={seq}: device-resident epoch loop "
          f"[{'epoch' if materialize else 'step'}-gather] {ms:7.1f} ms/step "
          f"-> {n * epochs / dt:8.0f} clips/s (warm-up epoch {warm_s:.1f}s; "
          f"the shuffle and exact mAP on the card, 2 scalars read an epoch)")
    return ms


def bench_ensemble(model_type: str, batch: int, seq: int, epochs: int,
                   n_batches: int, k: int, device="cuda", n_val: int = 0,
                   **overrides) -> dict:
    """Ensemble epochs (``train/ensemble.py``): K members over ONE resident
    corpus against a 1-member run of the same trainer.  ``t_K / (K t_1)``
    is the cost a member; the reference's equivalent is K runs.  Returns
    {"t1_ms", "tk_ms", "cost_per_member"} (ms an epoch, host clock; an
    epoch ends in its one read of the card)."""
    from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = _loop_config(model_type, batch, seq, overrides)
    n = batch * n_batches
    n_val = n_val or batch
    rng = np.random.default_rng(0)
    train = synthetic_corpus(cfg, batch, n, rng)
    val = synthetic_corpus(cfg, batch, n_val, rng)
    times = {}
    for members in (1, k):
        ens = EnsembleTrainer(cfg, device, n_models=members)
        ens.set_corpus_arrays("train", *train, n, batch)
        ens.set_corpus_arrays("validation", *val, n_val, batch)
        params, opt_state = ens.init_state()
        params, opt_state, step, *_ = ens.train_epoch(params, opt_state, 0, 0)
        t0 = time.perf_counter()
        for e in range(1, epochs + 1):
            params, opt_state, step, *_ = ens.train_epoch(params, opt_state,
                                                          e, step)
        times[members] = (time.perf_counter() - t0) / epochs
        del ens, params, opt_state
    t1, tk = times[1], times[k]
    print(f"{model_type:8s} B={batch} T={seq}: ensemble epoch x{k} members "
          f"{tk * 1e3:8.1f} ms vs x1 {t1 * 1e3:7.1f} ms -> "
          f"{k * t1 / tk:4.1f}x the throughput of sequential runs "
          f"({tk / t1 / k:.2f}x cost per member)")
    return {"t1_ms": t1 * 1e3, "tk_ms": tk * 1e3,
            "cost_per_member": tk / t1 / k}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--models", default="simple,bert,lstm",
        help="comma list of case names: "
             + ",".join(c[0] for c in DEFAULT_CASES))
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--forward", action="store_true",
                        help="also bench the eval-mode forward per case")
    parser.add_argument("--real-loop", action="store_true",
                        help="also run the streaming Trainer epoch loop")
    parser.add_argument("--device-loop", action="store_true",
                        help="also run the device-resident epoch loop")
    parser.add_argument("--epochs", type=int, default=3,
                        help="timed epochs of the loops")
    parser.add_argument("--batches", type=int, default=32,
                        help="batches an epoch of the loops")
    parser.add_argument("--ensemble", type=int, default=0, metavar="K",
                        help="also bench a K-member ensemble epoch against "
                             "a 1-member run (train/ensemble.py)")
    parser.add_argument("--device", default="cuda",
                        help="the device (cpu only when asked)")
    args = parser.parse_args(argv)
    wanted = set(args.models.split(","))
    for name, model_type, batch, seq, overrides in DEFAULT_CASES:
        # by case name only: 'bert' is the 512-window case, 'bert_full'
        # must be asked for by name
        if name not in wanted:
            continue
        bench_case(model_type, batch, seq, args.iters, args.device,
                   **overrides)
        if args.forward:
            bench_forward_case(model_type, batch, seq, args.iters,
                               args.device, **overrides)
        if args.real_loop:
            bench_real_loop(model_type, batch, seq, args.epochs,
                            args.batches, args.device, **overrides)
        if args.device_loop:
            bench_device_loop(model_type, batch, seq, args.epochs,
                              args.batches, args.device, **overrides)
        if args.ensemble:
            bench_ensemble(model_type, batch, seq, args.epochs, args.batches,
                           args.ensemble, args.device, **overrides)


if __name__ == "__main__":
    main()
