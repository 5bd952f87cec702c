"""Drive the PyTorch + CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:

1. report the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build the CUDA kernels from ``audio_tokens_tpu_torch/csrc/`` with nvcc;
3. hold each kernel to its plain PyTorch version on the card at the shapes
   its path gives it (B1 at 64 ten-second clips, B2 at the same batch's
   110,272 mel frames, B3 and B4 at T 1728, B 64, H 512, both directions,
   random prefix masks; B3 also with the residuals B4 needs) and time both
   with CUDA events;
4. serve: the full-width lstm classifier (vocab 500, embed 256, hidden
   512, 543 classes) behind ``ServingProgram`` answers 3 batches of 64
   clips, one single-clip request and one batch with per-clip min-max
   normalization (the route through B2).  The kernels' launch counters are
   reset just before and read just after; every kernel must have launched.
   The first two clips are then served on the CPU through the plain
   versions and the answers compared;
5. train: the same classifier, from a seeded random init, through
   ``ModelTrainer(config, cuda).run()`` for 8 steps of batch 64 on a
   synthetic token corpus written to a temp dir (543-class ontology and
   segment CSV, 512 training and 64 validation clips of 1728 ids, a split
   file), then one validation pass and a best checkpoint.  B3's and B4's
   counters are reset just before and read just after; both must have
   launched.  Then the trained weights go to a CPU model and one loss +
   backward on 4 rows of a batch is compared, gradient by gradient.

The line before the last is the card as nvidia-smi reports it, the one
before that the per-kernel JSON record, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
nonzero before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SR, CLIP_SECONDS, BATCH, VOCAB = 22050, 10.0, 64, 500
T_LSTM, B_LSTM, H_LSTM = 1728, 64, 512
# the package defaults: the lstm case of tools/bench_training.py
MODEL = dict(vocab_size=VOCAB, lstm_embed_dim=256, lstm_hidden_dim=512,
             num_layers=1, num_classes=543, max_seq_len=1728)
TRAIN_CLIPS, VAL_CLIPS, TRAIN_STEPS = 512, 64, 8
LSTM_ATOL = 1e-4   # 1728 f32 steps, another summation order
DW_RTOL = 1e-4     # dw_hh: max abs error / max |dw_hh| (110,528-row sums)
PROBS_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def make_clips(n: int, offset: int = 0) -> list:
    """bench.py's synthetic clips: two partials plus noise, seeded."""
    rng = np.random.default_rng(offset)
    t = np.arange(int(SR * CLIP_SECONDS)) / SR
    clips = []
    for i in range(offset, offset + n):
        f0 = 80.0 * (1 + (i % 16))
        x = (0.5 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 2.3 * f0 * t)
             + 0.1 * rng.standard_normal(len(t)))
        clips.append(x.astype(np.float32))
    return clips


def make_centroids() -> np.ndarray:
    """Unit-normalized normals from seed 7 (tools/serve_bench.py's recipe)."""
    rng = np.random.default_rng(7)
    cent = rng.standard_normal((VOCAB, 64)).astype(np.float32)
    return cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-10)


def write_token_corpus(base: Path, seed: int = 11) -> None:
    """A seeded synthetic corpus in the layout the trainer reads: ontology
    (543 classes), segment CSV (1-3 labels a clip), split file, and uint16
    token ids per clip under tokenized_audio/{train,validation}/."""
    rng = np.random.default_rng(seed)
    n_cls = MODEL["num_classes"]
    (base / "metadata").mkdir(parents=True)
    (base / "output").mkdir()
    (base / "metadata" / "ontology.json").write_text(json.dumps([
        {"id": f"/m/c{i:03d}", "name": f"class {i}", "restrictions": []}
        for i in range(n_cls)]))
    ytids = [f"clip{i:05d}" for i in range(TRAIN_CLIPS + VAL_CLIPS)]
    lines = ["# synthetic", "# segments", "# YTID, start, end, labels"]
    for y in ytids:
        labs = rng.choice(n_cls, size=int(rng.integers(1, 4)), replace=False)
        lines.append(f'{y}, 0.0, 10.0, "'
                     + ",".join(f"/m/c{j:03d}" for j in sorted(labs)) + '"')
    (base / "metadata" / "balanced_train_segments.csv").write_text(
        "\n".join(lines) + "\n")
    split = {"train": ytids[:TRAIN_CLIPS], "validation": ytids[TRAIN_CLIPS:]}
    (base / "output" / "bal_train_data_split.json").write_text(
        json.dumps(split))
    for name, ids in split.items():
        out = base / "tokenized_audio" / name
        out.mkdir(parents=True)
        for y in ids:
            np.save(out / f"{y}.npy",
                    rng.integers(0, VOCAB, MODEL["max_seq_len"])
                    .astype(np.uint16))


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_sequence_bwd, lstm_sequence_bwd_plain, lstm_sequence_fwd,
        lstm_sequence_fwd_plain)
    from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"[card] nvidia-smi: {card}")
    log(f"[card] torch: {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    exact_f32()

    # -- 2. build ---------------------------------------------------------
    secs = _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")
    for name in _build.KERNELS:
        text = (_build.BUILD_DIR / f"lib{name}.log").read_text() \
            if (_build.BUILD_DIR / f"lib{name}.log").exists() else ""
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. kernels vs plain on the card ------------------------------------
    cfg = AudioTokensConfig(clip_seconds=CLIP_SECONDS, **MODEL)
    cents = make_centroids()
    cents_t = torch.from_numpy(cents).to(dev)
    tok = FusedTokenizer(cfg, cents, dev)
    kern = tok.kernel
    batch, lengths = tok.frontend.prepare_batch(make_clips(BATCH))
    x = torch.from_numpy(batch).to(dev)
    records = []

    got = kern(x)
    ref = kern.plain(x)
    torch.cuda.synchronize()
    unit = l2_normalize(kern.log_mel_plain(x))
    frac, gap = check_near_ties(unit, cents_t, got, ref)
    ms, plain_ms = cuda_ms(lambda: kern(x), 10), cuda_ms(lambda: kern.plain(x), 5)
    log(f"[B1 tokenizer] tokens {tuple(got.shape)}: {frac:.2e} disagree, "
        f"largest score gap {gap:.3e} (near-tie bounds 1e-3, 1e-4); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    records.append(dict(
        name="B1 tokenizer (wav -> tokens)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/tokenizer.cu",
        replaces="audio_tokens_tpu/ops/pallas_tokenizer.py:222",
        max_abs_err=gap, ms=ms, plain_ms=plain_ms))

    frames = tok.frontend.mel_frames(x).reshape(-1, cfg.n_mels).contiguous()
    got = vq_argmin(frames, cents_t, True)
    ref = vq_argmin_plain(frames, cents_t, True)
    torch.cuda.synchronize()
    frac, gap = check_near_ties(l2_normalize(frames), cents_t, got, ref)
    ms = cuda_ms(lambda: vq_argmin(frames, cents_t, True), 10)
    plain_ms = cuda_ms(lambda: vq_argmin_plain(frames, cents_t, True), 5)
    log(f"[B2 vq] ids {tuple(got.shape)}: {frac:.2e} disagree, largest score "
        f"gap {gap:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    records.append(dict(
        name="B2 vq (normalize + nearest centroid)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/vq.cu",
        replaces="audio_tokens_tpu/ops/pallas_vq.py:37",
        max_abs_err=gap, ms=ms, plain_ms=plain_ms))

    gen = torch.Generator().manual_seed(3)
    bound = 1.0 / H_LSTM ** 0.5
    xg = torch.randn((T_LSTM, B_LSTM, 4 * H_LSTM), generator=gen).to(dev)
    w_hh = ((torch.rand((H_LSTM, 4 * H_LSTM), generator=gen) * 2 - 1)
            * bound).to(dev)
    lens = torch.randint(1, T_LSTM + 1, (B_LSTM,), generator=gen)
    mask = (torch.arange(T_LSTM)[:, None] < lens[None, :]).float().to(dev)
    err = res_err = 0.0
    fwd = {}  # per direction: the kernel's outputs with residuals
    for reverse in (False, True):
        hs, _, _, h_last = lstm_sequence_fwd(xg, mask, w_hh, reverse)
        fwd[reverse] = lstm_sequence_fwd(xg, mask, w_hh, reverse, True)
        ref = lstm_sequence_fwd_plain(xg, mask, w_hh, reverse)
        torch.cuda.synchronize()
        err = max(err, float((hs - ref[0]).abs().max()),
                  float((h_last - ref[3]).abs().max()))
        res_err = max(res_err, *(float((a - b).abs().max())
                                 for a, b in zip(fwd[reverse], ref)))
        del ref
    if not err <= LSTM_ATOL:
        raise AssertionError(f"B3 max abs err {err:.3e} > {LSTM_ATOL}")
    if not res_err <= LSTM_ATOL:
        raise AssertionError(f"B3 residuals max abs err {res_err:.3e} > "
                             f"{LSTM_ATOL}")

    def both(fn, *args):
        return lambda: (fn(xg, mask, w_hh, False, *args),
                        fn(xg, mask, w_hh, True, *args))

    ms = cuda_ms(both(lstm_sequence_fwd), 5)
    res_ms = cuda_ms(both(lstm_sequence_fwd, True), 5)
    plain_ms = cuda_ms(both(lstm_sequence_fwd_plain), 2)
    log(f"[B3 lstm] T {T_LSTM} B {B_LSTM} H {H_LSTM}, both directions: max "
        f"abs err {err:.3e} (atol {LSTM_ATOL}: 1728 f32 steps, another "
        f"summation order); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    log(f"[B3 residuals] gates (T, B, 4H) and c (T, B, H) as well: max abs "
        f"err {res_err:.3e} over hs, gates, c, h_last (atol {LSTM_ATOL}); "
        f"kernel {res_ms:.3f} ms (without the residual stores {ms:.3f} ms)")
    records.append(dict(
        name="B3 lstm forward (both directions)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/lstm.cu",
        replaces="audio_tokens_tpu/ops/pallas_lstm.py:50",
        max_abs_err=max(err, res_err), ms=ms, residuals_ms=res_ms,
        plain_ms=plain_ms))

    dhs = torch.randn((T_LSTM, B_LSTM, H_LSTM), generator=gen).to(dev)
    dh_last = torch.randn((B_LSTM, H_LSTM), generator=gen).to(dev)
    bwd_args = {r: (dhs, dh_last, fwd[r][1], fwd[r][2], fwd[r][0], mask,
                    w_hh, r) for r in (False, True)}
    dxg_err = dw_err = 0.0
    for reverse in (False, True):
        dxg, dw = lstm_sequence_bwd(*bwd_args[reverse])
        dxg_ref, dw_ref = lstm_sequence_bwd_plain(*bwd_args[reverse])
        torch.cuda.synchronize()
        dxg_err = max(dxg_err, float((dxg - dxg_ref).abs().max()))
        dw_err = max(dw_err, float((dw - dw_ref).abs().max())
                     / float(dw_ref.abs().max()))
        del dxg, dxg_ref
    if not dxg_err <= LSTM_ATOL:
        raise AssertionError(f"B4 dxg max abs err {dxg_err:.3e} > "
                             f"{LSTM_ATOL}")
    if not dw_err <= DW_RTOL:
        raise AssertionError(f"B4 dw_hh err / max|dw_hh| {dw_err:.3e} > "
                             f"{DW_RTOL}")

    def both_bwd(fn):
        return lambda: (fn(*bwd_args[False]), fn(*bwd_args[True]))

    ms = cuda_ms(both_bwd(lstm_sequence_bwd), 3)
    plain_ms = cuda_ms(both_bwd(lstm_sequence_bwd_plain), 2)
    log(f"[B4 lstm backward] T {T_LSTM} B {B_LSTM} H {H_LSTM}, both "
        f"directions: dxg max abs err {dxg_err:.3e} (atol {LSTM_ATOL}); "
        f"dw_hh max abs err / max |dw_hh| {dw_err:.3e} (bound {DW_RTOL}); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    records.append(dict(
        name="B4 lstm backward (both directions)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/lstm.cu",
        replaces="audio_tokens_tpu/ops/pallas_lstm.py:81",
        max_abs_err=dxg_err, dw_rel_err=dw_err, ms=ms, plain_ms=plain_ms))
    del fwd, bwd_args, dhs, dh_last, xg

    # -- 4. the slice answers requests ---------------------------------------
    prog = ServingProgram.from_components(
        cfg, tok, device=dev, generator=torch.Generator().manual_seed(0))
    cfg_n = AudioTokensConfig(clip_seconds=CLIP_SECONDS, **MODEL,
                              normalize=True)
    prog_n = ServingProgram.from_components(
        cfg_n, FusedTokenizer(cfg_n, cents, dev),
        prog.model.state_dict(), device=dev)
    batches = [tok.frontend.prepare_batch(make_clips(BATCH, BATCH * i))
               for i in range(3)]
    single = make_clips(1, 1000)

    def check(tokens, n_valid, probs, b):
        if tuple(tokens.shape) != (b, tok.frontend.frames_max):
            raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
        if tuple(probs.shape) != (b, cfg.num_classes) or n_valid.numel() != b:
            raise AssertionError(f"probs {tuple(probs.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= VOCAB:
            raise AssertionError("token id out of range")
        if not (torch.isfinite(probs).all() and probs.min() >= 0
                and probs.max() <= 1):
            raise AssertionError("probs not finite in [0, 1]")

    torch.cuda.synchronize()
    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd)
    for k in kernels:
        k.launches = 0
    batch_ms, outs = [], []
    for pb, pl in batches:
        t0 = time.perf_counter()
        out = prog(torch.from_numpy(pb), torch.from_numpy(pl))
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    t0 = time.perf_counter()
    one_tokens, one_probs = prog.predict_waveforms(single)
    single_ms = (time.perf_counter() - t0) * 1e3
    pb, pl = batches[0]
    t0 = time.perf_counter()
    out_n = prog_n(torch.from_numpy(pb), torch.from_numpy(pl))
    torch.cuda.synchronize()
    norm_ms = (time.perf_counter() - t0) * 1e3
    launches = [k.launches for k in kernels]
    for out in outs:
        check(*out, BATCH)
    check(*out_n, BATCH)
    if one_probs.shape != (1, cfg.num_classes) or len(one_tokens[0]) != \
            1 + cfg.clip_samples // cfg.hop_length:
        raise AssertionError("single-clip request answered wrongly")
    log(f"[serve] lstm {cfg.lstm_embed_dim}/{cfg.lstm_hidden_dim} x "
        f"{cfg.num_layers} layer, {cfg.num_classes} classes, T "
        f"{cfg.max_seq_len}: batches of {BATCH} took "
        f"{', '.join(f'{t:.1f}' for t in batch_ms)} ms (host clock, "
        f"host->card copy included); single clip {single_ms:.1f} ms; "
        f"normalize=True batch {norm_ms:.1f} ms")
    log(f"[serve] launches B1 {launches[0]}, B2 {launches[1]}, "
        f"B3 {launches[2]}")
    if min(launches) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for rec, n in zip(records, launches):
        rec["launches_by_path"] = {"serve": n}

    # reference on a small input: the first two clips through the plain
    # versions on the CPU, the classifier fed the card's tokens
    tok_cpu = FusedTokenizer(cfg, cents, "cpu")
    prog_cpu = ServingProgram.from_components(
        cfg, tok_cpu, {k: v.cpu() for k, v in prog.model.state_dict().items()},
        device="cpu")
    x2, l2 = torch.from_numpy(pb[:2]), torch.from_numpy(pl[:2])
    toks_gpu, _, probs_gpu = outs[0]
    toks_cpu, _, _ = prog_cpu(x2, l2)
    unit_cpu = l2_normalize(tok_cpu.kernel.log_mel_plain(x2))
    frac, gap = check_near_ties(unit_cpu, torch.from_numpy(cents),
                                toks_gpu[:2].cpu(), toks_cpu)
    seq = torch.zeros((2, cfg.max_seq_len), dtype=torch.int32)
    seq[:, : toks_gpu.shape[1]] = toks_gpu[:2].cpu()
    with torch.inference_mode():
        probs_cpu = torch.sigmoid(prog_cpu.model(seq))
    perr = float((probs_cpu - probs_gpu[:2].cpu()).abs().max())
    if not perr <= PROBS_ATOL:
        raise AssertionError(f"probs differ from the CPU path by {perr:.3e}")
    log(f"[reference] 2 clips on the CPU: tokens {frac:.2e} disagree (gap "
        f"{gap:.3e}); probs max abs err {perr:.3e} (atol {PROBS_ATOL})")
    del prog, prog_n, outs, out_n, batches

    # -- 5. the slice trains -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        write_token_corpus(base)
        tcfg = AudioTokensConfig(
            base_dir=str(base), **MODEL, training_batch_size=B_LSTM,
            epochs=1, max_train_steps=TRAIN_STEPS, num_workers=2,
            log_every_steps=0, device_corpus="off")
        trainer = ModelTrainer(tcfg, dev)
        step_ms = []
        train_step = trainer._train_step

        def timed_step(*args):
            t0 = time.perf_counter()
            out = train_step(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        trainer._train_step = timed_step  # synchronizes each step to time it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_kernels = (lstm_sequence_fwd, lstm_sequence_bwd)
        for k in train_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        val_loss, val_metrics = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        train_launches = [k.launches for k in train_kernels]
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        ckpt_ok = (Path(tcfg.checkpoint_dir) / "no-wandb-best"
                   / "params.pt").exists()
        log(f"[train] lstm {tcfg.lstm_embed_dim}/{tcfg.lstm_hidden_dim} x "
            f"{tcfg.num_layers} layer, {tcfg.num_classes} classes, T "
            f"{tcfg.max_seq_len}, batch {B_LSTM}: {len(step_ms)} steps, ms "
            f"per step {', '.join(f'{t:.1f}' for t in step_ms)} (host clock, "
            f"synchronized; median of steps 2..{len(step_ms)} "
            f"{statistics.median(step_ms[1:]):.2f} ms); run() {run_s:.1f} s "
            f"incl. corpus load, validation and checkpoint; val loss "
            f"{val_loss:.6f}, val mAP {val_metrics['mAP']:.6f}; peak "
            f"device memory {peak_gb:.2f} GiB")
        log(f"[train] launches B3 {train_launches[0]}, B4 "
            f"{train_launches[1]}; best checkpoint written: {ckpt_ok}")
        if len(step_ms) != TRAIN_STEPS or min(train_launches) < 1:
            raise AssertionError(f"training ran {len(step_ms)} steps, "
                                 f"launches {train_launches}")
        if not (np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0
                and ckpt_ok):
            raise AssertionError(f"val loss {val_loss}, mAP {val_metrics}")
        records[2]["launches_by_path"]["train"] = train_launches[0]
        records[3]["launches_by_path"] = {"train": train_launches[1]}
        for rec in records:
            rec["launches"] = sum(rec["launches_by_path"].values())

        # reference: the trained weights on the CPU, one loss + backward
        # on 4 rows of the first validation batch on each side
        from audio_tokens_tpu_torch.train.objective import weighted_bce

        _, val_loader = DataLoaderCreator(tcfg).get_dataloaders()
        batch = next(iter(val_loader.batches(0)))
        x4 = torch.from_numpy(batch["inputs"][:4])
        y4 = torch.from_numpy(batch["labels"][:4])
        w4 = torch.ones(4)
        cpu_model = get_model(tcfg, "cpu", torch.Generator().manual_seed(0))
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   trainer.model.state_dict().items()})
        losses, grads = [], []
        for model, d in ((trainer.model, dev), (cpu_model, "cpu")):
            model.train()
            model.zero_grad(set_to_none=True)
            loss = weighted_bce(model(x4.to(d)), y4.to(d), w4.to(d))
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({n: p.grad.cpu() for n, p in
                          model.named_parameters()})
        loss_err = abs(losses[0] - losses[1])
        worst = {}
        for name, ref in grads[1].items():
            diff = (grads[0][name] - ref).abs()
            worst[name] = (float(diff.max()),
                           float((diff - GRAD_RTOL * ref.abs()).max()))
        log(f"[train reference] 4 rows, loss card {losses[0]:.8f} vs CPU "
            f"{losses[1]:.8f} (|diff| {loss_err:.3e}, atol {LOSS_ATOL}); "
            f"largest gradient errors: "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in sorted(
                worst.items(), key=lambda kv: -kv[1][0])[:4])
            + f" (atol {GRAD_ATOL} + rtol {GRAD_RTOL})")
        if not loss_err <= LOSS_ATOL:
            raise AssertionError(f"train loss differs by {loss_err:.3e}")
        bad = {n: e for n, (e, over) in worst.items() if over > GRAD_ATOL}
        if bad:
            raise AssertionError(f"gradients differ from the CPU: {bad}")

    print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
