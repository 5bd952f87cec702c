"""Drive the PyTorch + CUDA port's serving and training paths once on one
NVIDIA GPU, for the lstm and the bert classifiers.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:

1. report the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build the CUDA kernels from ``audio_tokens_tpu_torch/csrc/`` with nvcc
   (one process per source, in parallel);
3. hold each kernel to its plain PyTorch version on the card at the shapes
   its path gives it, and time kernel, plain version and, where one
   PyTorch call computes the same function, that call (``library_ms``, a
   yardstick the port never calls) with CUDA events: B1 at 64 ten-second
   clips (beside it the DFT product alone, one cuBLAS GEMM on the frames),
   B2 at the same batch's 110,272 mel frames against 500 and 16,384
   centroids (two records), B3 and B4 at T 1728,
   B 64, H 512, both directions (B3 also with the residuals B4 needs; the
   library call is cuDNN's bidirectional ``nn.LSTM``; B3's time a step is
   printed; B4's recurrence and its ``dw_hh`` GEMM are timed apart, the
   GEMM beside cuBLAS on the same views, each with its rate and the GEMM
   with its own bound), B5 forward at (64, 12, 1728, 64)
   in bf16 and f32 and its dk/dv and dq kernels at (8, 12, 1728, 64),
   random prefix lengths with a 0 (the library call is
   ``scaled_dot_product_attention`` with the segment mask; its backward
   gives dq, dk and dv together, so the pair's sum is printed beside it;
   each kernel's rate on the work these lengths need; the f32 forward, dk/dv
   and dq kernels, 3xTF32 on the tensor cores, have records of their own).  Each
   record carries ``bound_ms``: the larger of the bytes the function must
   move over 3.35 TB/s and its operations over the card's peak for their
   type (67 TFLOP/s f32 FMA, 989 TFLOP/s bf16, 165 TFLOP/s for the 3xTF32
   f32 kernels, whose records also carry the FMA bound as ``fma_bound_ms``),
   from this run's shapes and lengths;
4. serve the lstm: the full-width classifier (vocab 500, embed 256, hidden
   512, 543 classes) behind ``ServingProgram`` answers 3 batches of 64
   clips, one single-clip request and one batch with per-clip min-max
   normalization (the route through B2).  The kernels' launch counters are
   reset just before and read just after; every kernel must have launched.
   Then one batch with per-clip normalization through a 16,384-token
   vocabulary (B2's ring instance), its counters reset and read around it.
   The first two clips are then served on the CPU and the answers compared;
5. serve bert: the full-width classifier (hidden 768, 12 heads, MLP 3072,
   2 layers, window 1728, 543 classes, bf16 compute,
   ``transformer_attention="flash"``; ``tools/bench_training.py``'s
   ``bert_full`` case) answers 3 batches of 64 clips and one single clip
   through B1 and B5; B1's and B5's counters must move.  One batch more goes
   through the plain (``"xla"``) route with the same weights.  Then 2 clips
   through an f32 program (B5's f32 forward, its counter read around it),
   card vs CPU;
6. train the lstm through ``ModelTrainer(config, cuda).run()`` for 8 steps
   of batch 64 on a synthetic token corpus written to a temp dir (543-class
   ontology and segment CSV, 512 training and 64 validation clips of 1728
   ids, a split file), then one validation pass and a best checkpoint; B3
   and B4 must have launched.  The trained weights go to a CPU model and
   one loss + backward on 4 rows is compared, gradient by gradient;
7. train bert the same way for 8 steps of batch 8 (training steps take the
   plain attention route, as the JAX model does; validation runs B5, whose
   launches must move), then one loss + backward on 4 rows at f32, card vs
   CPU, in training mode and through an eval-mode forward, the way
   ``jax.grad`` reaches the library kernel's backward: that pass launches
   B5's f32 dk/dv and dq kernels (their counters are read around it).  The
   same loss + backward is then timed on the card (CUDA events) through the
   eval-mode (B5) route in bf16 (the bf16 pair's counters read around it)
   and f32 and, in bf16, through the training-mode (plain) route;
8. run the staged pipeline, ``audio_tokens_tpu_torch.run_pipeline.main(cfg,
   cuda)``, at the package defaults (64 mel, n_fft 512, hop 128, vocab 500,
   20 Lloyd iterations a ``batch_warm_start`` batch, the full-width lstm)
   with 1 epoch: a temp workspace holds phase 6's ontology and segment CSV
   and 512 training plus 64 validation ten-second 16-bit wavs (every 6th
   stereo, one at 44.1 kHz so that the resampler runs); spectrograms,
   centroids, tokens, 8 training steps of 64 and a validation pass follow.
   Each stage's seconds and the kernels' launches in it are printed: B2 in
   the clustering stage (the Lloyd assignment, ``normalize=False``) and in
   the tokenize stage (``normalize=True``), B3 and B4 in training; the B2
   record's ``launches_by_path`` gains ``pipeline_cluster`` and
   ``pipeline_tokenize``, B3's and B4's ``pipeline_train``.  Then the card's
   results are held against the CPU: the first 8 clips' spectrograms
   recomputed from the decoded waves, one Lloyd iteration from the saved
   centroids over the first 64 clips' frames, and 8 clips' tokens.  Last,
   K-means at the real size of a default clustering batch (10,000 clips,
   17.23M unit rows x 64, made on the card from a seed): two
   ``KMeans.train`` fits at vocab 500 and 20 iterations, which must be
   bit-equal, the iteration split into the assignment (B2) and the
   centroid sums (sorted rows), each beside its bound, the sums as the JAX
   package forms them (a one-hot GEMM) and the assignment by
   ``torch.matmul`` + ``argmin`` in chunks as yardsticks.

The line before the last is the card as nvidia-smi reports it, the one
before that the per-kernel JSON record, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
nonzero before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SR, CLIP_SECONDS, BATCH, VOCAB = 22050, 10.0, 64, 500
VOCAB_LARGE = 16384  # B2 streams these centroids (4 MB at d 64) through a ring
T_LSTM, B_LSTM, H_LSTM = 1728, 64, 512
# the package defaults: the lstm case of tools/bench_training.py
MODEL = dict(vocab_size=VOCAB, lstm_embed_dim=256, lstm_hidden_dim=512,
             num_layers=1, num_classes=543, max_seq_len=1728)
TRAIN_CLIPS, VAL_CLIPS, TRAIN_STEPS = 512, 64, 8
# tools/bench_training.py bert_full: hidden 768 (12 heads of 64), 2 layers,
# the whole 1728-token clip attended; compute_dtype stays the default bf16
BERT = dict(model_type="bert", vocab_size=VOCAB, hidden_size=768,
            num_layers=2, num_classes=543, max_seq_len=1728,
            transformer_max_position=1728, dropout=0.0,
            transformer_attention="flash")
B_BERT_TRAIN = 8
HEADS, HEAD_DIM, SM_SCALE = 12, 64, 0.125
B_ATT_BWD = 8
# B5 vs its plain version: f32 1728-term sums in another order; bf16 P and
# the output (or P and dS) each rounded to 8 bits, at other points
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATT_BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of the largest entry
# H100 SXM dense peaks at 700 W (NVIDIA data sheet); f32 work on the tensor
# cores in 3xTF32 (three tf32 products for one f32 product) runs at a third
# of the 495 TFLOP/s TF32 rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
RESAMPLED_CLIP = 5  # the pipeline's one clip at 44.1 kHz
KMEANS_CLIPS = 10_000  # config.clustering_batch_size: one default batch
SPEC_ATOL, SPEC_RTOL = 5e-3, 1e-4  # dB: another DFT summation order
CENT_ATOL = 1e-5   # one Lloyd step's centroids, other summation orders
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


def make_clips(n: int, offset: int = 0, sr: int = SR) -> list:
    """bench.py's synthetic clips: two partials plus noise, seeded."""
    rng = np.random.default_rng(offset)
    t = np.arange(int(sr * CLIP_SECONDS)) / sr
    clips = []
    for i in range(offset, offset + n):
        f0 = 80.0 * (1 + (i % 16))
        x = (0.5 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 2.3 * f0 * t)
             + 0.1 * rng.standard_normal(len(t)))
        clips.append(x.astype(np.float32))
    return clips


def make_centroids(k: int = VOCAB, seed: int = 7) -> np.ndarray:
    """Unit-normalized normals from a seed (tools/serve_bench.py's recipe:
    seed 7)."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((k, 64)).astype(np.float32)
    return cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-10)


def write_labels(base: Path, rng) -> dict:
    """The metadata of a synthetic corpus: ontology (543 classes), segment
    CSV (1-3 labels a clip) and split file of TRAIN_CLIPS + VAL_CLIPS
    clips; returns the split."""
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
    return split


def write_token_corpus(base: Path, seed: int = 11) -> None:
    """A seeded synthetic corpus in the layout the trainer reads:
    ``write_labels``' metadata and uint16 token ids per clip under
    tokenized_audio/{train,validation}/."""
    rng = np.random.default_rng(seed)
    split = write_labels(base, rng)
    for name, ids in split.items():
        out = base / "tokenized_audio" / name
        out.mkdir(parents=True)
        for y in ids:
            np.save(out / f"{y}.npy",
                    rng.integers(0, VOCAB, MODEL["max_seq_len"])
                    .astype(np.uint16))


def bound_of(flop: float, nbytes: float, dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of operations over the card's peak
    for ``dtype`` and bytes over its memory rate."""
    ops_ms = flop / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def kernel_name(mangled: str) -> str:
    """A kernel's name from its Itanium-mangled one: the last component of
    the nested name (``_ZN<len><namespace><len><name>``), with template
    integers in angle brackets."""
    import re

    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name = mangled[i:i + int(n)]
        i += int(n)
    if mangled[i:i + 1] == "I":  # template arguments up to "EE"
        args = re.findall(r"L[ib](\d+)E", mangled[i:mangled.find("EE", i) + 1])
        name += f"<{', '.join(args)}>"
    return name


def ptxas_usage(log_path: Path) -> list:
    """[(kernel, "stack frame, spills; registers")] for each entry function
    in an nvcc ``-Xptxas -v`` log."""
    import re

    if not log_path.exists():
        return []
    found, kernel, frame = [], None, ""
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif kernel and "stack frame" in line:
            frame = line.strip()
        elif kernel and "Used" in line:
            found.append((kernel, f"{frame}; {line.split(':', 1)[1].strip()}"))
            kernel, frame = None, ""
    return found


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


def timed_run(trainer, kernels):
    """trainer.run() with every step synchronized and timed and the launch
    counters of ``kernels`` reset just before -> (val_loss, val_metrics,
    step_ms, run_s, peak_gb, launches)."""
    import torch

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
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    val_loss, val_metrics = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    return val_loss, val_metrics, step_ms, run_s, peak_gb, launches


def card_vs_cpu_grads(tag: str, card_model, cpu_model, x, y, w,
                      train: bool) -> None:
    """One weighted-BCE loss + backward on each side (training or eval
    mode); the losses within LOSS_ATOL and every gradient within
    GRAD_ATOL + GRAD_RTOL * |CPU's|."""
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    losses, grads = [], []
    for model in (card_model, cpu_model):
        d = next(model.parameters()).device
        model.train(train)
        model.zero_grad(set_to_none=True)
        loss = weighted_bce(model(x.to(d)), y.to(d), w.to(d))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    loss_err = abs(losses[0] - losses[1])
    worst = {}
    for name, ref in grads[1].items():
        diff = (grads[0][name] - ref).abs()
        worst[name] = (float(diff.max()),
                       float((diff - GRAD_RTOL * ref.abs()).max()))
    log(f"{tag} {len(x)} rows, loss card {losses[0]:.8f} vs CPU "
        f"{losses[1]:.8f} (|diff| {loss_err:.3e}, atol {LOSS_ATOL}); "
        f"largest gradient errors: "
        + ", ".join(f"{n} {e:.3e}" for n, (e, _) in sorted(
            worst.items(), key=lambda kv: -kv[1][0])[:4])
        + f" (atol {GRAD_ATOL} + rtol {GRAD_RTOL})")
    if not loss_err <= LOSS_ATOL:
        raise AssertionError(f"{tag} loss differs by {loss_err:.3e}")
    bad = {n: e for n, (e, over) in worst.items() if over > GRAD_ATOL}
    if bad:
        raise AssertionError(f"{tag} gradients differ from the CPU: {bad}")


def loss_backward_ms(model, x, y, w, train: bool, iters: int = 5) -> float:
    """Mean milliseconds of one weighted-BCE loss + backward of ``model`` on
    the card, in training or eval mode (CUDA events)."""
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    d = next(model.parameters()).device
    x, y, w = x.to(d), y.to(d), w.to(d)
    model.train(train)

    def step():
        model.zero_grad(set_to_none=True)
        weighted_bce(model(x), y, w).backward()

    return cuda_ms(step, iters)


def first_val_rows(cfg, n: int):
    """The first n rows of the first validation batch: inputs, labels and
    unit row weights (host tensors)."""
    import torch

    from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator

    _, val_loader = DataLoaderCreator(cfg).get_dataloaders()
    batch = next(iter(val_loader.batches(0)))
    return (torch.from_numpy(batch["inputs"][:n]),
            torch.from_numpy(batch["labels"][:n]), torch.ones(n))


def attention_inputs(b: int, dtype, seed: int):
    """q, k, v, do (b, 12, 1728, 64) on the card and prefix segment ids
    from random lengths, the first 0; plus the (b, 1, T, 1) valid-row
    mask (positions below each length)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    shape = (b, HEADS, MODEL["max_seq_len"], HEAD_DIM)
    q, k, v, do = (torch.randn(shape, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    t = shape[2]
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[0] = 0
    pos = torch.arange(t)[None, :]
    seg = (pos >= lens[:, None]).to(torch.int32).cuda()
    valid = (pos < lens[:, None])[:, None, :, None].cuda()
    # the work these lengths need: each query against its own segment
    pairs = int((lens ** 2 + (t - lens) ** 2).sum()) * HEADS
    return q, k, v, do, seg, valid, pairs


def attention_phases(records: list) -> None:
    """[B5 attention] and [B5 backward]: each kernel vs its plain version,
    timed beside ``scaled_dot_product_attention`` on the same inputs."""
    import torch
    import torch.nn.functional as F

    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_plain, flash_attention_dq_plain,
        flash_attention_fwd, flash_attention_plain)

    def sdpa_mask(seg):
        return seg[:, None, :, None] == seg[:, None, None, :]

    fwd = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        q, k, v, _, seg, valid, pairs = attention_inputs(BATCH, dtype, 5)
        got = flash_attention_fwd(q, k, v, seg, SM_SCALE)[0]
        ref = flash_attention_plain(q, k, v, seg, SM_SCALE)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err_valid = float((diff * valid).max())
        err_all = float(diff.max())
        del got, ref, diff
        if not max(err_valid, err_all) <= ATT_TOL[name]:
            raise AssertionError(f"B5 forward {name}: max abs err "
                                 f"{err_valid:.3e} (valid rows), "
                                 f"{err_all:.3e} (all) > {ATT_TOL[name]}")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, seg, SM_SCALE), 5)
        plain_ms = cuda_ms(
            lambda: flash_attention_plain(q, k, v, seg, SM_SCALE), 2)
        mask = sdpa_mask(seg)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=SM_SCALE), 5)
        nbytes = 4 * q.numel() * q.element_size() + seg.numel() * 4
        flop = 4 * HEAD_DIM * pairs  # the work these lengths need
        # the f32 forward runs 3xTF32 on the tensor cores
        peak = "tf32x3" if name == "float32" else name
        b_ms, b_by = bound_of(flop, nbytes, peak)
        fwd[name] = dict(err=err_valid, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         fma_bound_ms=bound_of(flop, nbytes, name)[0])
        share = (f" ({b_ms / ms:.0%} of the 3xTF32 bound; f32 FMA bound "
                 f"{fwd[name]['fma_bound_ms']:.3f} ms)"
                 if name == "float32" else "")
        log(f"[B5 attention] {name} q, k, v {tuple(q.shape)}, prefix lengths "
            f"with a 0: max abs err {err_valid:.3e} on valid rows, "
            f"{err_all:.3e} on all (atol {ATT_TOL[name]}); kernel {ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms, scaled_dot_product_attention "
            f"{lib_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}){share}; on the "
            f"work these lengths need {flop / ms / 1e9:.1f} TFLOP/s of "
            f"{flop / 1e9:.1f} GFLOP")
        del q, k, v, seg, valid, mask
    for name, kind in (("bfloat16", "bf16"), ("float32", "f32, 3xTF32")):
        r = fwd[name]
        rec = dict(
            name=f"B5 flash attention forward ({kind})", route="cuda",
            source="audio_tokens_tpu_torch/csrc/attention.cu",
            replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:331 "
                     "(called at audio_tokens_tpu/models/transformer.py:133)",
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"])
        if name == "float32":
            rec["fma_bound_ms"] = r["fma_bound_ms"]
        records.append(rec)

    bwd = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        q, k, v, do, seg, _, pairs = attention_inputs(B_ATT_BWD, dtype, 6)
        o, lse = flash_attention_fwd(q, k, v, seg, SM_SCALE, True)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, seg, lse, do, di, SM_SCALE)
        got = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
        ref = (*flash_attention_dkv_plain(*args),
               flash_attention_dq_plain(*args))
        torch.cuda.synchronize()
        abs_errs = {g: float((a.float() - b.float()).abs().max())
                    for g, a, b in zip(("dk", "dv", "dq"), got, ref)}
        errs = {g: abs_errs[g] / float(b.float().abs().max())
                for g, b in zip(("dk", "dv", "dq"), ref)}
        del got, ref
        if not max(errs.values()) <= ATT_BWD_RTOL[name]:
            raise AssertionError(f"B5 backward {name}: {errs} > "
                                 f"{ATT_BWD_RTOL[name]} of the largest entry")
        dkv_ms = cuda_ms(lambda: flash_attention_bwd_dkv(*args), 5)
        dq_ms = cuda_ms(lambda: flash_attention_bwd_dq(*args), 5)
        dkv_plain = cuda_ms(lambda: flash_attention_dkv_plain(*args), 2)
        dq_plain = cuda_ms(lambda: flash_attention_dq_plain(*args), 2)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(
            *leaves, attn_mask=sdpa_mask(seg), scale=SM_SCALE)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 5)
        el = q.element_size()
        io = q.numel() * el
        rows = 2 * lse.numel() * 4 + seg.numel() * 4  # lse, di, seg
        # the f32 pair runs 3xTF32 on the tensor cores
        peak = "tf32x3" if name == "float32" else name
        dkv_b = bound_of(8 * HEAD_DIM * pairs, 6 * io + rows, peak)
        dq_b = bound_of(6 * HEAD_DIM * pairs, 5 * io + rows, peak)
        fma = (bound_of(8 * HEAD_DIM * pairs, 6 * io + rows, name)[0],
               bound_of(6 * HEAD_DIM * pairs, 5 * io + rows, name)[0])
        bwd[name] = dict(errs=abs_errs, dkv=(dkv_ms, dkv_plain, dkv_b),
                         dq=(dq_ms, dq_plain, dq_b), library_ms=lib_ms,
                         fma_bound_ms=fma)
        shares = (f" ({dkv_b[0] / dkv_ms:.0%} and {dq_b[0] / dq_ms:.0%} of "
                  f"the 3xTF32 bounds; f32 FMA bounds {fma[0]:.3f} and "
                  f"{fma[1]:.3f} ms)" if name == "float32" else "")
        log(f"[B5 backward] {name} {tuple(q.shape)}: max abs err / max |ref| "
            + ", ".join(f"{g} {e:.3e}" for g, e in errs.items())
            + f" (bound {ATT_BWD_RTOL[name]}); dk/dv kernel {dkv_ms:.3f} ms "
            f"(plain {dkv_plain:.3f}, bound {dkv_b[0]:.3f} {dkv_b[1]}), dq "
            f"kernel {dq_ms:.3f} ms (plain {dq_plain:.3f}, bound "
            f"{dq_b[0]:.3f} {dq_b[1]}){shares}; the pair "
            f"{dkv_ms + dq_ms:.3f} ms vs scaled_dot_product_attention "
            f"backward (dq, dk, dv together) {lib_ms:.3f} ms; on the work "
            f"these lengths need dk/dv "
            f"{8 * HEAD_DIM * pairs / dkv_ms / 1e9:.1f} TFLOP/s of "
            f"{8 * HEAD_DIM * pairs / 1e9:.1f} GFLOP, dq "
            f"{6 * HEAD_DIM * pairs / dq_ms / 1e9:.1f} TFLOP/s of "
            f"{6 * HEAD_DIM * pairs / 1e9:.1f} GFLOP")
        del q, k, v, do, o, lse, di, args, leaves, out
    for name, kind in (("bfloat16", "bf16"), ("float32", "f32, 3xTF32")):
        r = bwd[name]
        for i, (key, label, line, err) in enumerate((
                ("dkv", "dk/dv", 796, max(r["errs"]["dk"], r["errs"]["dv"])),
                ("dq", "dq", 1146, r["errs"]["dq"]))):
            ms, plain_ms, (b_ms, b_by) = r[key]
            rec = dict(
                name=f"B5 flash attention backward {label} ({kind})",
                route="cuda",
                source="audio_tokens_tpu_torch/csrc/attention.cu",
                replaces=f"jax/experimental/pallas/ops/tpu/"
                         f"flash_attention.py:{line}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=r["library_ms"])
            if name == "float32":
                rec["fma_bound_ms"] = r["fma_bound_ms"][i]
            records.append(rec)
    torch.cuda.empty_cache()


def write_audio_corpus(base: Path, seed: int = 12) -> dict:
    """The pipeline's workspace: ``write_labels``' metadata and one 16-bit
    ten-second wav a clip under audioset/bal_train/, from ``make_clips`` at
    22,050 Hz, every 6th stereo and clip RESAMPLED_CLIP at 44.1 kHz (the
    stage resamples it); returns the split."""
    from audio_tokens_tpu_torch.data.audio_io import write_pcm_wav

    split = write_labels(base, np.random.default_rng(seed))
    ytids = split["train"] + split["validation"]
    for start in range(0, len(ytids), BATCH):
        clips = make_clips(min(BATCH, len(ytids) - start), start)
        for i, (y, x) in enumerate(zip(ytids[start:], clips), start):
            sr = 44100 if i == RESAMPLED_CLIP else SR
            if sr != SR:
                x = make_clips(1, i, sr)[0]
            write_pcm_wav(base / "audioset" / "bal_train" / y[:2]
                          / f"{y}.wav", x, sr, channels=2 if i % 6 == 0 else 1)
    return split


def clock_stages(stages, kernels, seconds: dict, launches: dict):
    """Wrap each stage class's ``run`` so that it records its seconds (host
    clock, synchronized) and the launches of ``kernels`` made inside it;
    returns the function that restores the classes."""
    import torch

    saved = {cls: cls.__dict__.get("run") for cls in stages}
    for cls in stages:
        def run(self, _run=cls.run, _name=cls.__name__):
            torch.cuda.synchronize()
            before = [k.launches for k in kernels]
            t0 = time.perf_counter()
            out = _run(self)
            torch.cuda.synchronize()
            seconds[_name] = time.perf_counter() - t0
            launches[_name] = [k.launches - b for k, b in zip(kernels,
                                                               before)]
            return out

        cls.run = run

    def restore():
        for cls, run in saved.items():
            if run is None:
                del cls.run
            else:
                cls.run = run

    return restore


def agreeing_centroid_error(ids, ids_ref, cents, cents_ref) -> float:
    """Largest centroid difference over the clusters whose members are the
    same in both assignments."""
    import torch

    moved = torch.cat([ids[ids != ids_ref], ids_ref[ids != ids_ref]])
    same = torch.ones(cents.shape[0], dtype=torch.bool)
    same[moved.long()] = False
    return float((cents[same] - cents_ref[same]).abs().max())


def pipeline_phase(records: list, dev) -> None:
    """Phase 8: ``run_pipeline.main`` on a wav workspace at the package
    defaults, its results against the CPU, then K-means at real size."""
    import torch

    from audio_tokens_tpu_torch import run_pipeline
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.vq import (check_near_ties, l2_normalize,
                                               vq_assign_fused)
    from audio_tokens_tpu_torch.processors import (ClusterCreator,
                                                   ModelTrainer,
                                                   SpecTokenizer,
                                                   SpectrogramGenerator)

    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd,
               lstm_sequence_bwd)
    stages = (SpectrogramGenerator, ClusterCreator, SpecTokenizer,
              ModelTrainer)
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        t0 = time.perf_counter()
        split = write_audio_corpus(base)
        write_s = time.perf_counter() - t0
        cfg = AudioTokensConfig(base_dir=str(base), **MODEL,
                                training_batch_size=B_LSTM, epochs=1)
        seconds, launches = {}, {}
        restore = clock_stages(stages, kernels, seconds, launches)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            val_loss, val_metrics = run_pipeline.main(cfg, dev)
        finally:
            restore()
        run_s = time.perf_counter() - t0
        total = [k.launches for k in kernels]

        spec_dir = Path(cfg.dest_spec_path) / "train"
        tok_dir = Path(cfg.dest_tokenized_path) / "train"
        train_ids = sorted(split["train"])
        frames = sum(np.load(tok_dir / f"{y}.npy", mmap_mode="r").shape[0]
                     for y in train_ids)
        cents = np.load(cfg.centroids_path)
        names = [c.__name__ for c in stages]
        log(f"[pipeline] run_pipeline.main at the package defaults (n_mels "
            f"{cfg.n_mels}, n_fft {cfg.n_fft}, hop {cfg.hop_length}, vocab "
            f"{cfg.vocab_size}, niter {cfg.niter}, {cfg.kmeans_mode}, lstm "
            f"{cfg.lstm_embed_dim}/{cfg.lstm_hidden_dim}, {cfg.num_classes} "
            f"classes), {len(split['train'])} + {len(split['validation'])} "
            f"wavs of {CLIP_SECONDS:g} s (written in {write_s:.1f} s): "
            + ", ".join(f"{n} {seconds[n]:.2f} s" for n in names)
            + f" (host clock, synchronized); main() {run_s:.2f} s; train "
            f"corpus {frames} frames; val loss {val_loss:.6f}, val mAP "
            f"{val_metrics['mAP']:.6f}")
        log("[pipeline] launches B1, B2, B3, B4 by stage: "
            + "; ".join(f"{n} {launches[n]}" for n in names)
            + f"; whole run {total}")
        b2_cluster = launches["ClusterCreator"][1]
        b2_tokenize = launches["SpecTokenizer"][1]
        b3_train, b4_train = launches["ModelTrainer"][2:]
        if frames != TRAIN_CLIPS * (1 + cfg.clip_samples // cfg.hop_length):
            raise AssertionError(f"train corpus has {frames} frames")
        if cents.shape != (cfg.vocab_size, cfg.n_mels) or \
                cents.dtype != np.float32:
            raise AssertionError(f"centroids {cents.shape} {cents.dtype}")
        if (b2_cluster < cfg.niter or b2_tokenize < 2 or b3_train < 1
                or b4_train < 1):
            raise AssertionError(f"a kernel of the pipeline launched too "
                                 f"rarely: {launches}")
        if not (np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0):
            raise AssertionError(f"val loss {val_loss}, mAP {val_metrics}")
        records[1]["launches_by_path"].update(
            pipeline_cluster=b2_cluster, pipeline_tokenize=b2_tokenize)
        records[2]["launches_by_path"]["pipeline_train"] = b3_train
        records[3]["launches_by_path"]["pipeline_train"] = b4_train

        # the card's results against the CPU: spectrograms from the
        # decoded waves (clip 0 stereo, clip 5 resampled), one Lloyd step
        # from the saved centroids, tokens from the saved centroids
        spec_err = 0.0
        n_specs = 0
        cpu_cfg = dataclasses.replace(cfg, device_batch_size=8)
        for y, spec in SpectrogramGenerator(cpu_cfg, "cpu").iter_specs(
                train_ids[:8]):
            card = np.load(spec_dir / f"{y}.npy")
            if card.shape != spec.shape:
                raise AssertionError(f"{y}: spectrogram {card.shape} vs "
                                     f"{spec.shape} on the CPU")
            diff = np.abs(card - spec)
            if (diff > SPEC_ATOL + SPEC_RTOL * np.abs(spec)).any():
                raise AssertionError(f"{y}: spectrogram differs from the "
                                     f"CPU's by {diff.max():.3e} dB")
            spec_err = max(spec_err, float(diff.max()))
            n_specs += 1
        if n_specs != 8:
            raise AssertionError(f"{n_specs} of 8 spectrograms on the CPU")
        x = l2_normalize(torch.from_numpy(np.concatenate(
            [np.load(spec_dir / f"{y}.npy").T for y in train_ids[:64]])))
        c = torch.from_numpy(cents)
        step = {}
        for d in (dev, "cpu"):
            ids = km.assign(x.to(d), c.to(d)).cpu()
            new, obj = km.kmeans_fit(x.to(d), cfg.vocab_size, 1,
                                     init_centroids=c.to(d))
            step[str(d)] = (ids, new.cpu(), obj)
        card, cpu = step[str(dev)], step["cpu"]
        frac, gap = check_near_ties(x, c, card[0], cpu[0])
        cent_err = agreeing_centroid_error(card[0], cpu[0], card[1], cpu[1])
        if not cent_err <= CENT_ATOL:
            raise AssertionError(f"Lloyd step: centroids differ from the "
                                 f"CPU's by {cent_err:.3e}")
        tok_frames = torch.from_numpy(np.concatenate(
            [np.load(spec_dir / f"{y}.npy").T for y in train_ids[:8]]))
        tok_card = torch.from_numpy(np.concatenate(
            [np.load(tok_dir / f"{y}.npy") for y in train_ids[:8]]))
        tok_frac, tok_gap = check_near_ties(
            l2_normalize(tok_frames), c, tok_card,
            vq_assign_fused(tok_frames, c, normalize=True))
        log(f"[pipeline reference] CPU vs card: 8 spectrograms max abs err "
            f"{spec_err:.3e} dB (atol {SPEC_ATOL} + rtol {SPEC_RTOL}); one "
            f"Lloyd step over {x.shape[0]} frames of 64 clips: ids "
            f"{frac:.2e} disagree (gap {gap:.3e}), centroids max abs err "
            f"{cent_err:.3e} (atol {CENT_ATOL}), objective card "
            f"{card[2]:.6f} vs CPU {cpu[2]:.6f}; tokens of 8 clips "
            f"{tok_frac:.2e} disagree (gap {tok_gap:.3e})")
        del x, c, tok_frames, tok_card, step

    # K-means at the size of one default clustering batch
    n = KMEANS_CLIPS * (1 + cfg.clip_samples // cfg.hop_length)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    x = torch.randn((n, cfg.n_mels), generator=gen, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10
    fits, fit_s = [], []
    for _ in range(2):
        fit = km.KMeans(cfg.n_mels, cfg.vocab_size, niter=cfg.niter,
                        seed=cfg.random_seed, device=dev)
        torch.cuda.synchronize()
        before = vq_argmin.launches
        t0 = time.perf_counter()
        fit.train(x)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        if vq_argmin.launches - before != cfg.niter:
            raise AssertionError(f"a fit launched B2 "
                                 f"{vq_argmin.launches - before} times")
        fits.append(fit)
    if not (torch.equal(fits[0].centroids, fits[1].centroids)
            and fits[0].obj == fits[1].obj):
        raise AssertionError("two card K-means fits differ")
    c = fits[0].centroids
    assign_ms = cuda_ms(lambda: km.assign(x, c), 3)
    ids = km.assign(x, c)
    sums_ms = cuda_ms(lambda: km.cluster_sums(x, ids, cfg.vocab_size), 3)
    rows = torch.arange(cfg.vocab_size, dtype=ids.dtype, device=dev)[:, None]

    def onehot_sums():  # the JAX formulation, timed beside the one adopted
        sums = torch.zeros_like(c)
        for i in range(0, n, 1 << 16):
            sums += (ids[None, i:i + (1 << 16)] == rows).float() @ x[
                i:i + (1 << 16)]
        return sums

    onehot_ms = cuda_ms(onehot_sums, 2)
    sums, _ = km.cluster_sums(x, ids, cfg.vocab_size)
    onehot_err = float((onehot_sums() - sums).abs().max())
    if not onehot_err <= 1e-5 * float(sums.abs().max()):
        raise AssertionError(f"cluster sums differ from the one-hot GEMM's "
                             f"by {onehot_err:.3e}")
    lib_ms = cuda_ms(lambda: vq_argmin_plain(x, c, False, chunk=1 << 18), 2)
    lib_frac, lib_gap = check_near_ties(
        x, c, ids, vq_argmin_plain(x, c, False, chunk=1 << 18))
    flop = 2 * n * cfg.vocab_size * cfg.n_mels
    nbytes = x.numel() * 4 + n * 4 + c.numel() * 4
    assign_b = bound_of(flop, nbytes)
    # the sums read each row and id once and add each row once; the
    # one-hot GEMM does as many operations as the assignment
    sums_b = bound_of(x.numel(), nbytes)
    onehot_b = bound_of(flop, nbytes)
    iter_ms = min(fit_s) / cfg.niter * 1e3
    rate = n * cfg.niter / min(fit_s)
    log(f"[kmeans] {n} unit rows x {cfg.n_mels}, vocab {cfg.vocab_size}, "
        f"{cfg.niter} iterations: KMeans.train {fit_s[0]:.3f} s and "
        f"{fit_s[1]:.3f} s (host clock, synchronized), bit-equal; "
        f"{iter_ms:.2f} ms an iteration, {rate / 1e6:.1f}M point-iterations/s; "
        f"assignment (B2) {assign_ms:.3f} ms, bound {assign_b[0]:.3f} ms "
        f"({assign_b[1]}, {flop / 1e12:.3f} TFLOP f32); sums (sorted rows, "
        f"f64 running sums in blocks of {km.SEGMENT_BLOCK}) {sums_ms:.3f} "
        f"ms, bound {sums_b[0]:.3f} ms ({sums_b[1]}); the one-hot GEMM "
        f"in chunks of {1 << 16} instead {onehot_ms:.3f} ms (bound "
        f"{onehot_b[0]:.3f} ms, {onehot_b[1]}; max abs diff "
        f"{onehot_err:.3e}); rest of the iteration "
        f"{iter_ms - assign_ms - sums_ms:.3f} ms; yardstick torch.matmul + "
        f"argmin in chunks of {1 << 18} (TF32 off) {lib_ms:.3f} ms, ids "
        f"{lib_frac:.2e} disagree with B2's (gap {lib_gap:.3e})")
    records[1]["kmeans_17M"] = dict(
        rows=n, iteration_ms=iter_ms, point_iters_per_s=rate,
        assign_ms=assign_ms, assign_bound_ms=assign_b[0], sums_ms=sums_ms,
        sums_bound_ms=sums_b[0], onehot_sums_ms=onehot_ms,
        onehot_sums_bound_ms=onehot_b[0], matmul_argmin_ms=lib_ms)
    del x, ids, fits, c, sums
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_dw_hh, lstm_sequence_bwd, lstm_sequence_bwd_plain,
        lstm_sequence_fwd, lstm_sequence_fwd_plain)
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
        for kernel, usage in ptxas_usage(_build.BUILD_DIR / f"lib{name}.log"):
            log(f"[build] {name} {kernel}: {usage}")

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
    # yardstick: the DFT product alone, one cuBLAS f32 GEMM on the frames
    # laid out beforehand (no single PyTorch call computes B1's function)
    frames = x[:, :kern.padded_len].unfold(1, cfg.n_fft, cfg.hop_length)[
        :, :kern.n_frames].reshape(-1, cfg.n_fft).contiguous()
    dft_ms = cuda_ms(lambda: torch.matmul(frames, kern.basis), 10)
    dft_flop = 2 * frames.shape[0] * cfg.n_fft * kern.basis.shape[1]
    del frames
    log(f"[B1 tokenizer] tokens {tuple(got.shape)}: {frac:.2e} disagree, "
        f"largest score gap {gap:.3e} (near-tie bounds 1e-3, 1e-4); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; the DFT product alone "
        f"(torch.matmul, TF32 off) {dft_ms:.3f} ms, "
        f"{dft_flop / dft_ms / 1e9:.1f} TFLOP/s of {dft_flop / 1e9:.1f} "
        f"GFLOP; the kernel's whole function at "
        f"{dft_flop / ms / 1e9:.1f} TFLOP/s on the DFT's work")
    n_frames = BATCH * tok.frontend.frames_max
    bins = cfg.n_fft // 2 + 1
    b_ms, b_by = bound_of(  # DFT (re, im), mel, distances; f32 FMA
        n_frames * (2 * cfg.n_fft * 2 * bins + 2 * bins * cfg.n_mels
                    + 2 * cfg.n_mels * VOCAB),
        x.numel() * 4 + n_frames * 4 + cents.nbytes)
    records.append(dict(
        name="B1 tokenizer (wav -> tokens)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/tokenizer.cu",
        replaces="audio_tokens_tpu/ops/pallas_tokenizer.py:222",
        max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, dft_product_ms=dft_ms))

    frames = tok.frontend.mel_frames(x).reshape(-1, cfg.n_mels).contiguous()
    n, d = frames.shape
    cents_large = make_centroids(VOCAB_LARGE, 8)
    b2 = []
    for c_np in (cents, cents_large):
        c_t = torch.from_numpy(c_np).to(dev)
        k = c_np.shape[0]
        got = vq_argmin(frames, c_t, True)
        ref = vq_argmin_plain(frames, c_t, True)
        torch.cuda.synchronize()
        frac, gap = check_near_ties(l2_normalize(frames), c_t, got, ref)
        ms = cuda_ms(lambda: vq_argmin(frames, c_t, True), 10)
        plain_ms = cuda_ms(lambda: vq_argmin_plain(frames, c_t, True), 5)
        b_ms, b_by = bound_of(2 * n * d * k + 3 * n * d,
                              frames.numel() * 4 + c_np.nbytes + n * 4)
        log(f"[B2 vq] ids {tuple(got.shape)}, K {k}: {frac:.2e} disagree, "
            f"largest score gap {gap:.3e}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}); "
            f"{2 * n * d * k / ms / 1e9:.1f} TFLOP/s")
        b2.append(dict(
            name="B2 vq (normalize + nearest centroid)"
            + (f", K {k}" if k != VOCAB else ""), route="cuda",
            source="audio_tokens_tpu_torch/csrc/vq.cu",
            replaces="audio_tokens_tpu/ops/pallas_vq.py:37",
            max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        del c_t, got, ref
    records.append(b2[0])  # B2 at K 16,384 goes last (records[10])

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
    # library yardstick: cuDNN's bidirectional LSTM, forward and backward
    # (it also does the input projection x @ w_ih, which B3 is handed)
    cudnn = torch.nn.LSTM(MODEL["lstm_embed_dim"], H_LSTM,
                          bidirectional=True).to(dev)
    x_lib = torch.randn((T_LSTM, B_LSTM, MODEL["lstm_embed_dim"]),
                        generator=gen).to(dev).requires_grad_()
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: cudnn(x_lib), 5)
    out_lib = cudnn(x_lib)[0]
    g_lib = torch.randn_like(out_lib)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out_lib, [x_lib, *cudnn.parameters()], g_lib, retain_graph=True), 3)
    del cudnn, x_lib, out_lib, g_lib
    log(f"[library] cuDNN nn.LSTM({MODEL['lstm_embed_dim']}, {H_LSTM}, "
        f"bidirectional) at T {T_LSTM} B "
        f"{B_LSTM}, TF32 off: forward {lib_ms:.3f} ms, backward "
        f"{lib_bwd_ms:.3f} ms (yardstick only)")
    step_us = ms / (2 * T_LSTM) * 1e3
    log(f"[B3 lstm] T {T_LSTM} B {B_LSTM} H {H_LSTM}, both directions: max "
        f"abs err {err:.3e} (atol {LSTM_ATOL}: 1728 f32 steps, another "
        f"summation order); kernel {ms:.3f} ms ({step_us:.2f} us a step), "
        f"plain {plain_ms:.3f} ms")
    log(f"[B3 residuals] gates (T, B, 4H) and c (T, B, H) as well: max abs "
        f"err {res_err:.3e} over hs, gates, c, h_last (atol {LSTM_ATOL}); "
        f"kernel {res_ms:.3f} ms (without the residual stores {ms:.3f} ms)")
    step_flop = 2 * B_LSTM * H_LSTM * 4 * H_LSTM  # h @ w_hh, one step
    b_ms, b_by = bound_of(2 * T_LSTM * step_flop, 2 * 4 * (
        xg.numel() + mask.numel() + w_hh.numel() + T_LSTM * B_LSTM * H_LSTM
        + B_LSTM * H_LSTM))
    records.append(dict(
        name="B3 lstm forward (both directions)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/lstm.cu",
        replaces="audio_tokens_tpu/ops/pallas_lstm.py:50",
        max_abs_err=max(err, res_err), ms=ms, step_us=step_us,
        residuals_ms=res_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

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
    # B4's two kernels apart: its dw_hh GEMM alone on the same hs and dxg,
    # the recurrence being the rest
    dxg_of = {r: lstm_sequence_bwd(*bwd_args[r])[0] for r in (False, True)}
    dw_ms = cuda_ms(lambda: [lstm_dw_hh(bwd_args[r][4], dxg_of[r], r)
                             for r in (False, True)], 3)
    # yardstick of the dw_hh GEMM: cuBLAS on the same time-shifted views
    # (hs one step back in processing order against dxg), TF32 off
    shifted = {False: (slice(None, -1), slice(1, None)),
               True: (slice(1, None), slice(None, -1))}
    dw_lib_ms = cuda_ms(lambda: [torch.matmul(
        bwd_args[r][4][shifted[r][0]].reshape(-1, H_LSTM).t(),
        dxg_of[r][shifted[r][1]].reshape(-1, 4 * H_LSTM))
        for r in (False, True)], 3)
    del dxg_of
    plain_ms = cuda_ms(both_bwd(lstm_sequence_bwd_plain), 2)
    tbh = T_LSTM * B_LSTM * H_LSTM  # dhs, c, hs; gates and dxg are 4x
    dw_flop = 2 * (T_LSTM - 1) * step_flop  # both directions
    dw_b_ms, _ = bound_of(dw_flop, 2 * 4 * (5 * tbh + w_hh.numel()))
    log(f"[B4 lstm backward] T {T_LSTM} B {B_LSTM} H {H_LSTM}, both "
        f"directions: dxg max abs err {dxg_err:.3e} (atol {LSTM_ATOL}); "
        f"dw_hh max abs err / max |dw_hh| {dw_err:.3e} (bound {DW_RTOL}); "
        f"kernel {ms:.3f} ms (recurrence {ms - dw_ms:.3f} ms, "
        f"{(ms - dw_ms) / 2 / (T_LSTM - 1) * 1e3:.2f} us a step; dw_hh GEMM "
        f"{dw_ms:.3f} ms, {dw_flop / dw_ms / 1e9:.1f} TFLOP/s of "
        f"{dw_flop / 1e9:.1f} GFLOP, bound {dw_b_ms:.3f} ms; cuBLAS "
        f"torch.matmul on the same views {dw_lib_ms:.3f} ms, "
        f"{dw_flop / dw_lib_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"cuDNN backward {lib_bwd_ms:.3f} ms")
    b_ms, b_by = bound_of(
        2 * (T_LSTM + T_LSTM - 1) * step_flop,  # dgp @ w_hh^T, dw_hh
        2 * 4 * (3 * tbh + 2 * 4 * tbh + mask.numel() + 2 * w_hh.numel()
                 + B_LSTM * H_LSTM))
    records.append(dict(
        name="B4 lstm backward (both directions)", route="cuda",
        source="audio_tokens_tpu_torch/csrc/lstm.cu",
        replaces="audio_tokens_tpu/ops/pallas_lstm.py:81",
        max_abs_err=dxg_err, dw_rel_err=dw_err, ms=ms,
        recurrence_ms=ms - dw_ms, dw_ms=dw_ms, dw_library_ms=dw_lib_ms,
        dw_bound_ms=dw_b_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd_ms))
    del fwd, bwd_args, dhs, dh_last, xg
    attention_phases(records)
    records.append(b2[1])

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

    def check(tokens, n_valid, probs, b, vocab=VOCAB):
        if tuple(tokens.shape) != (b, tok.frontend.frames_max):
            raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
        if tuple(probs.shape) != (b, cfg.num_classes) or n_valid.numel() != b:
            raise AssertionError(f"probs {tuple(probs.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
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

    # a 16,384-token vocabulary through the normalize route: B2's ring
    cfg_l = AudioTokensConfig(clip_seconds=CLIP_SECONDS,
                              **{**MODEL, "vocab_size": VOCAB_LARGE},
                              normalize=True)
    prog_l = ServingProgram.from_components(
        cfg_l, FusedTokenizer(cfg_l, cents_large, dev), device=dev,
        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    vq_argmin.launches = 0
    t0 = time.perf_counter()
    out_l = prog_l(torch.from_numpy(pb), torch.from_numpy(pl))
    torch.cuda.synchronize()
    large_ms = (time.perf_counter() - t0) * 1e3
    large_launches = vq_argmin.launches
    check(*out_l, BATCH, VOCAB_LARGE)
    log(f"[serve 16k] lstm, {VOCAB_LARGE}-token vocabulary, normalize=True: "
        f"batch of {BATCH} took {large_ms:.1f} ms (host clock, first call); "
        f"launches B2 {large_launches}")
    if large_launches < 1:
        raise AssertionError("B2 never launched on the 16k-vocabulary batch")
    b2[1]["launches_by_path"] = {"serve_16k": large_launches}
    del prog_l, out_l

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
    del prog, prog_n, outs, out_n

    # -- 5. bert answers requests --------------------------------------------
    bcfg = AudioTokensConfig(clip_seconds=CLIP_SECONDS, **BERT)
    bprog = ServingProgram.from_components(
        bcfg, tok, device=dev, generator=torch.Generator().manual_seed(0))
    weights = bprog.model.state_dict()
    xprog = ServingProgram.from_components(
        AudioTokensConfig(clip_seconds=CLIP_SECONDS,
                          **{**BERT, "transformer_attention": "xla"}),
        tok, weights, device=dev)
    torch.cuda.synchronize()
    serve_kernels = (TokenizerKernel, flash_attention_fwd)
    for k in serve_kernels:
        k.launches = 0
    batch_ms, outs = [], []
    for pb, pl in batches:
        t0 = time.perf_counter()
        out = bprog(torch.from_numpy(pb), torch.from_numpy(pl))
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    t0 = time.perf_counter()
    one_tokens, one_probs = bprog.predict_waveforms(single)
    single_ms = (time.perf_counter() - t0) * 1e3
    bert_launches = [k.launches for k in serve_kernels]
    pb, pl = batches[0]
    t0 = time.perf_counter()
    out_x = xprog(torch.from_numpy(pb), torch.from_numpy(pl))
    torch.cuda.synchronize()
    xla_ms = (time.perf_counter() - t0) * 1e3
    for out in (*outs, out_x):
        check(*out, BATCH)
    if one_probs.shape != (1, bcfg.num_classes):
        raise AssertionError("bert single-clip request answered wrongly")
    route_gap = float((outs[0][2] - out_x[2]).abs().max())
    log(f"[serve bert] hidden {bcfg.hidden_size} x {bcfg.num_layers} layers, "
        f"window {bcfg.transformer_max_position}, {bcfg.num_classes} classes, "
        f"{bcfg.compute_dtype}, flash: batches of {BATCH} took "
        f"{', '.join(f'{t:.1f}' for t in batch_ms)} ms (host clock, host->"
        f"card copy included); single clip {single_ms:.1f} ms; the same "
        f"weights through the plain 'xla' route: batch {xla_ms:.1f} ms; "
        f"probs flash vs xla max abs diff {route_gap:.3e} (bf16, not bound)")
    log(f"[serve bert] launches B1 {bert_launches[0]}, B5 forward "
        f"{bert_launches[1]}")
    if min(bert_launches) < 1:
        raise AssertionError(f"a kernel of the bert path never launched: "
                             f"{bert_launches}")
    records[0]["launches_by_path"]["serve_bert"] = bert_launches[0]
    records[4]["launches_by_path"] = {"serve_bert": bert_launches[1]}

    # reference: 2 clips through an f32 program on the card and the CPU
    fcfg = AudioTokensConfig(clip_seconds=CLIP_SECONDS,
                             **{**BERT, "compute_dtype": "float32"})
    fprog = ServingProgram.from_components(fcfg, tok, weights, device=dev)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    toks_gpu, _, probs_gpu = fprog(x2, l2)
    torch.cuda.synchronize()
    f32_serve_launches = flash_attention_fwd.launches
    if f32_serve_launches < 1:
        raise AssertionError("the f32 bert program skipped B5's forward")
    records[5]["launches_by_path"] = {"serve_bert_f32": f32_serve_launches}
    cpu_bert = get_model(fcfg, "cpu", torch.Generator().manual_seed(0))
    cpu_bert.load_state_dict({k: v.cpu() for k, v in weights.items()})
    cpu_bert.eval()
    seq = torch.zeros((2, fcfg.max_seq_len), dtype=torch.int32)
    seq[:, : toks_gpu.shape[1]] = toks_gpu.cpu()
    with torch.inference_mode():
        probs_cpu = torch.sigmoid(cpu_bert(seq))
    perr = float((probs_cpu - probs_gpu.cpu()).abs().max())
    if not perr <= PROBS_ATOL:
        raise AssertionError(f"bert probs differ from the CPU by {perr:.3e}")
    log(f"[reference bert] 2 clips, f32 program: card (B5) vs CPU (plain "
        f"attention) probs max abs err {perr:.3e} (atol {PROBS_ATOL}); "
        f"launches B5 f32 forward {f32_serve_launches}")
    del bprog, xprog, fprog, outs, out_x, batches, weights, cpu_bert
    torch.cuda.empty_cache()

    # -- 6. the lstm trains ---------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        write_token_corpus(base)
        tcfg = AudioTokensConfig(
            base_dir=str(base), **MODEL, training_batch_size=B_LSTM,
            epochs=1, max_train_steps=TRAIN_STEPS, num_workers=2,
            log_every_steps=0, device_corpus="off")
        trainer = ModelTrainer(tcfg, dev)
        (val_loss, val_metrics, step_ms, run_s, peak_gb,
         train_launches) = timed_run(trainer, (lstm_sequence_fwd,
                                               lstm_sequence_bwd))
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

        # reference: the trained weights on the CPU, one loss + backward
        # on 4 rows of the first validation batch on each side
        cpu_model = get_model(tcfg, "cpu", torch.Generator().manual_seed(0))
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   trainer.model.state_dict().items()})
        card_vs_cpu_grads("[train reference]", trainer.model, cpu_model,
                          *first_val_rows(tcfg, 4), train=True)
        del trainer, cpu_model
        torch.cuda.empty_cache()

        # -- 7. bert trains ----------------------------------------------------
        bt_cfg = AudioTokensConfig(
            base_dir=str(base), **BERT, training_batch_size=B_BERT_TRAIN,
            epochs=1, max_train_steps=TRAIN_STEPS, num_workers=2,
            log_every_steps=0, device_corpus="off",
            checkpoint_dir=str(base / "bert_checkpoints"))
        btrainer = ModelTrainer(bt_cfg, dev)
        b5 = (flash_attention_fwd, flash_attention_bwd_dkv,
              flash_attention_bwd_dq)
        (val_loss, val_metrics, step_ms, run_s, peak_gb,
         b5_launches) = timed_run(btrainer, b5)
        log(f"[train bert] hidden {bt_cfg.hidden_size} x {bt_cfg.num_layers} "
            f"layers, window {bt_cfg.transformer_max_position}, "
            f"{bt_cfg.compute_dtype}, batch {B_BERT_TRAIN}: {len(step_ms)} "
            f"steps, ms per step {', '.join(f'{t:.1f}' for t in step_ms)} "
            f"(host clock, synchronized; median of steps 2..{len(step_ms)} "
            f"{statistics.median(step_ms[1:]):.2f} ms); run() {run_s:.1f} s "
            f"incl. corpus load, validation and checkpoint; val loss "
            f"{val_loss:.6f}, val mAP {val_metrics['mAP']:.6f}; peak "
            f"device memory {peak_gb:.2f} GiB")
        log(f"[train bert] launches B5 forward {b5_launches[0]} (validation), "
            f"dk/dv {b5_launches[1]}, dq {b5_launches[2]} (training steps "
            f"take the plain route)")
        if (len(step_ms) != TRAIN_STEPS or b5_launches[0] < 1
                or b5_launches[1:] != [0, 0]):
            raise AssertionError(f"bert training ran {len(step_ms)} steps, "
                                 f"B5 launches {b5_launches}")
        if not (np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0):
            raise AssertionError(f"val loss {val_loss}, mAP {val_metrics}")
        records[4]["launches_by_path"]["train_bert"] = b5_launches[0]

        # reference at f32: the trained weights on the card and the CPU, a
        # training step's gradient (plain attention), then the gradient
        # through an eval-mode forward (B5 and its two backward kernels)
        f32_cfg = AudioTokensConfig(
            base_dir=str(base), **{**BERT, "compute_dtype": "float32"},
            training_batch_size=B_BERT_TRAIN)
        state = btrainer.model.state_dict()
        card_bert, cpu_bert = (
            get_model(f32_cfg, d, torch.Generator().manual_seed(0))
            for d in (dev, "cpu"))
        card_bert.load_state_dict(state)
        cpu_bert.load_state_dict({k: v.cpu() for k, v in state.items()})
        rows = first_val_rows(f32_cfg, 4)
        card_vs_cpu_grads("[train bert reference] training mode:",
                          card_bert, cpu_bert, *rows, train=True)
        for k in b5:
            k.launches = 0
        card_vs_cpu_grads("[train bert reference] eval mode, flash:",
                          card_bert, cpu_bert, *rows, train=False)
        grad_launches = [k.launches for k in b5]
        log(f"[train bert reference] eval-mode gradient launches: B5 forward "
            f"{grad_launches[0]}, dk/dv {grad_launches[1]}, dq "
            f"{grad_launches[2]}")
        if min(grad_launches) < 1:
            raise AssertionError(f"the eval-mode gradient skipped a B5 "
                                 f"kernel: {grad_launches}")
        records[5]["launches_by_path"]["eval_grad_f32"] = grad_launches[0]
        records[8]["launches_by_path"] = {"eval_grad_f32": grad_launches[1]}
        records[9]["launches_by_path"] = {"eval_grad_f32": grad_launches[2]}
        # the one place a model reaches the backward pair, timed: bf16 is
        # the trained model itself, which runs the bf16 pair
        for k in b5:
            k.launches = 0
        eval_bf16 = loss_backward_ms(btrainer.model, *rows, train=False)
        bf16_launches = [k.launches for k in b5]
        log(f"[train bert reference] bf16 eval-mode loss + backward "
            f"launches: B5 forward {bf16_launches[0]}, dk/dv "
            f"{bf16_launches[1]}, dq {bf16_launches[2]}")
        if min(bf16_launches) < 1:
            raise AssertionError(f"the bf16 eval-mode gradient skipped a B5 "
                                 f"kernel: {bf16_launches}")
        records[6]["launches_by_path"] = {"eval_grad_bf16": bf16_launches[1]}
        records[7]["launches_by_path"] = {"eval_grad_bf16": bf16_launches[2]}
        records[4]["launches_by_path"]["eval_grad_bf16"] = bf16_launches[0]
        plain_bf16 = loss_backward_ms(btrainer.model, *rows, train=True)
        eval_f32 = loss_backward_ms(card_bert, *rows, train=False)
        log(f"[train bert reference] loss + backward on {len(rows[0])} rows "
            f"(CUDA events): eval mode (B5 forward, dk/dv, dq) bf16 "
            f"{eval_bf16:.3f} ms, f32 {eval_f32:.3f} ms; training mode "
            f"(plain attention) bf16 {plain_bf16:.3f} ms")
        del btrainer, card_bert, cpu_bert, state
        torch.cuda.empty_cache()

    # -- 8. the pipeline, wav files to a trained checkpoint ------------------
    pipeline_phase(records, dev)

    for rec in records:
        rec["launches"] = sum(rec["launches_by_path"].values())
    print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
