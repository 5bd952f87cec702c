"""Drive the PyTorch + CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:

1. report the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build the CUDA kernels from ``audio_tokens_tpu_torch/csrc/`` with nvcc;
3. hold each kernel to its plain PyTorch version on the card at the serving
   shapes (B1 at 64 ten-second clips, B2 at the same batch's 110,272 mel
   frames, B3 at T 1728, B 64, H 512, both directions, random prefix
   masks) and time both with CUDA events;
4. serve: the full-width lstm classifier (vocab 500, embed 256, hidden
   512, 543 classes) behind ``ServingProgram`` answers 3 batches of 64
   clips, one single-clip request and one batch with per-clip min-max
   normalization (the route through B2).  The kernels' launch counters are
   reset just before and read just after; every kernel must have launched.
   The first two clips are then served on the CPU through the plain
   versions and the answers compared.

The line before the last is the card as nvidia-smi reports it, the one
before that the per-kernel JSON record, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
nonzero before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SR, CLIP_SECONDS, BATCH, VOCAB = 22050, 10.0, 64, 500
T_LSTM, B_LSTM, H_LSTM = 1728, 64, 512
LSTM_ATOL = 1e-4
PROBS_ATOL = 1e-4


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
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_sequence, lstm_sequence_plain)
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
    cfg = AudioTokensConfig(clip_seconds=CLIP_SECONDS, vocab_size=VOCAB)
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
    err = 0.0
    for reverse in (False, True):
        hs, h_last = lstm_sequence(xg, mask, w_hh, reverse)
        hs_ref, h_ref = lstm_sequence_plain(xg, mask, w_hh, reverse)
        torch.cuda.synchronize()
        err = max(err, float((hs - hs_ref).abs().max()),
                  float((h_last - h_ref).abs().max()))
    if not err <= LSTM_ATOL:
        raise AssertionError(f"B3 max abs err {err:.3e} > {LSTM_ATOL}")

    def both(fn):
        return lambda: (fn(xg, mask, w_hh, False), fn(xg, mask, w_hh, True))

    ms = cuda_ms(both(lstm_sequence), 5)
    plain_ms = cuda_ms(both(lstm_sequence_plain), 2)
    log(f"[B3 lstm] T {T_LSTM} B {B_LSTM} H {H_LSTM}, both directions: max "
        f"abs err {err:.3e} (atol {LSTM_ATOL}: 1728 f32 steps, another "
        f"summation order); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    records.append(dict(
        name="B3 lstm forward (both directions)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/lstm.cu",
        replaces="audio_tokens_tpu/ops/pallas_lstm.py:50",
        max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # -- 4. the slice answers requests ---------------------------------------
    prog = ServingProgram.from_components(
        cfg, tok, device=dev, generator=torch.Generator().manual_seed(0))
    cfg_n = AudioTokensConfig(clip_seconds=CLIP_SECONDS, vocab_size=VOCAB,
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
    kernels = (TokenizerKernel, vq_argmin, lstm_sequence)
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
        rec["launches"] = n

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

    print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
