"""Drive the PyTorch + CUDA port's serving and training paths once on one
NVIDIA GPU, for the five classifiers (lstm, bert, simple, cnn, baseline).

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
   centroids and, at 128 mel bins, 500 (the sliced ring instance, rows
   wider than d 100; beside it ``torch.matmul`` + argmin over all rows; three
   records), B3 and B4 at T 1728,
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
   vocabulary (B2's ring instance) and one at 128 mel bins (its sliced
   ring instance), each with its counters reset and read around it.
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
   centroids, tokens, 8 training steps of 64 and a validation pass follow
   (a device-resident epoch: the default ``device_corpus="auto"`` puts the
   token corpus on the card, so the training stage's seconds include its
   packing).
   Each stage's seconds and the kernels' launches in it are printed: B2 in
   the clustering stage (the Lloyd assignment, ``normalize=False``) and in
   the tokenize stage (``normalize=True``), B3 and B4 in training; the B2
   record's ``launches_by_path`` gains ``pipeline_cluster`` and
   ``pipeline_tokenize``, B3's and B4's ``pipeline_train``.  Then the card's
   results are held against the CPU: the first 8 clips' spectrograms
   recomputed from the decoded waves (with where the largest gap sits: mel
   bin, frame, the CPU's dB there, and the largest gap over bins above -80
   dB), one Lloyd iteration from the saved centroids over the first 64
   clips' frames, and 8 clips' tokens.  The clustering stage then runs
   ``kmeans_mode="full"`` through the streaming fit (4 super-batches of
   262,144 of the 882,176 frames): uninterrupted, stopped by a raising
   checkpoint wrapper after iteration 5 and resumed with
   ``incremental=True``, bit-equal (``launches_by_path``
   ``pipeline_cluster_stream``).  Last, K-means at the real size of a
   default clustering batch (10,000 clips, 17.23M unit rows x 64, made on
   the card from a seed): two ``KMeans.train`` fits at vocab 500 and 20
   iterations, which must be bit-equal, with their peak device memory;
   the iteration split into the assignment (B2) and the centroid sums
   (sorted rows), each beside its bound, and the sums split into the sort,
   the gather and the f64 running sums; the sums as the JAX package forms
   them (a one-hot GEMM) and the assignment by ``torch.matmul`` +
   ``argmin`` in chunks as yardsticks.  The same rows then go to the host
   and stream back through ``kmeans_fit_streaming`` (17 super-batches of
   1,048,576, the in-memory fit's init) in four modes: re-stream, host
   cache, device (HBM) cache and the bf16 wire with the device cache.  The
   f32 modes must be bit-equal and within 1e-5 of the in-memory fit (ids
   apart at near-ties only), the bf16 mode within 1e-5 of the in-memory
   fit of the bf16-rounded rows; each mode prints its ms an iteration,
   its time waiting on the stream, its host-to-card GB/s, its peak device
   memory and B2's launches (340 a fit; ``launches_by_path``
   ``kmeans_stream``);
9. run the fused pipeline (``fused_pipeline=True``) on phase 8's audio,
   each run in a workspace of its own: in ``batch_warm_start`` no
   spectrogram is written, the centroids must equal phase 8's bit for bit,
   B1 tokenizes all 576 clips in the tokenize stage (9 launches,
   ``launches_by_path`` ``pipeline_fused_tokenize``; B2 in clustering,
   ``pipeline_fused_cluster``) and its tokens are held to phase 8's (the
   mel frontend + B2) under the near-tie rule, with the count of frames
   apart and the largest float64 gap (``[fused tokens]``).  Then
   ``kmeans_mode="full"`` twice: staged with ``kmeans_streaming="never"``
   (its split file in a shuffled order, so that each clip sits at another
   row of another batch than in the fused mode's sorted batches) and fused,
   where the device feed must engage, the centroids must equal the staged
   fit's bit for bit and the train split must come from the resident frames
   (B2 ``pipeline_fused_resident``, B1 only for validation); each stage's
   seconds are printed for both.  Last, the device feed at one default
   clustering batch (``[fused feed]``): 10,000 ten-second clips from memory
   (157 batches of 64, cycling 4 made once) through
   ``ClusterCreator._feed_batch`` into a 4.44 GB capacity buffer, then
   ``kmeans_fit`` on its view (vocab 500, 20 iterations); the first batch's
   rows bit-equal to the host-mediated route's, and the peak device memory
   at most the buffer plus phase 8's in-memory fit overhead plus 1 GB (a
   copied view would pass it);
10. on phase 8's workspace, train the simple (hidden 768), cnn and baseline
   classifiers (``tools/bench_training.py``'s cases; cnn and baseline at
   the default bf16) for 8 steps of 64 through ``ModelTrainer(config,
   cuda).run()``, each with its ms a step, the step's bound (its FLOPs
   over the peak for its type against AdamW's bytes), peak memory and
   parameter count; the trained weights' loss + backward on 4 rows, card
   vs CPU, at f32 and (cnn, baseline) at bf16, bounded by twice the CPU's
   own bf16 error.  Then every family serves from its checkpoint through
   ``ServingProgram(config, "no-wandb-best", device=cuda)``: those three,
   the lstm from phase 8's checkpoint (B1 + B3), bert from phase 7's with
   ``transformer_attention="flash"`` (B1 + B5), one batch of 64 and one
   clip each, the counters reset and read around them
   (``launches_by_path`` ``serve_ckpt_<family>``), the tokens equal to
   ``FusedTokenizer``'s, 2 clips at f32 card vs CPU; and ``ManualTester``
   (``Predictor``) reports one validation clip, its probabilities held to
   the serving program's;
11. on phase 10's checkpoints, the serving export: the lstm (phase 8's
   checkpoint) and bert (phase 7's, ``flash``) exported in kernel form
   (``export_serving(portable=False)``) at batch 64 on the card and loaded
   (``load_serving``); the loaded program's tokens and n_valid equal to the
   live ``ServingProgram``'s and its probs within 1e-5; B1 + B3 and B1 + B5
   launched by the loaded program (``launches_by_path`` ``export_lstm``,
   ``export_bert``); the export and load seconds, the artifact's bytes and
   a batch of 64 (inputs on the card) through the loaded and the live
   program, median of 3.  Then the lstm exported portable on the CPU,
   loaded onto the card, 8 clips through it (no kernel launched), its
   tokens held to the kernel program's under the near-tie rule and its
   probs within 1e-4.  ``torch.library.opcheck`` of the eight custom ops on
   small card tensors (the forward ops also with inputs that require a
   gradient, which runs B4's and B5's backward ops as their autograd).  Last, ``tools/serve_bench`` in-process at its
   default 512 ten-second clips (8 batches of 64): tokens, ``--classify
   lstm`` and ``--classify bert`` (window 1728, flash), each with
   ``--latency 200``; clips/s and the request percentiles and maximum
   (``launches_by_path`` ``serve_bench_<branch>``), each with
   ``--audio_backend python`` (the decode these numbers were first taken
   with);
12. the precision tiers, the conv front-end and the native decoder: B1 at
   each combo of ``tools/bench_tokenizer_tiers`` ((highest, bf16x3),
   (bf16x3, bf16x3), (default, default) beside (highest, highest)) at K
   500 and 16,384 on 64 ten-second clips, and (bf16x3, bf16x3) and
   (default, default) at the shapes PR 16's front end refused (C5:
   n_fft 400 with hop 200 and 100, 256 mel bands), driven through ``FusedTokenizer``
   with the config's tiers and held to its plain tier version under the
   near-tie rule with the coarser tier's bound (``ops/tiers.py``), and to
   its tier against the ``highest`` kernel (``check_follows_tier``: the
   share of tokens apart within the tier's band, the plain tier's answer
   taken where it leaves ``highest``), a record each
   (``tiers_b1_<tier>_<vq_tier>_k<K>``; yardstick the DFT product alone
   in bf16); B2 at bf16x3 and default at phase 8's 17.23M rows x 64 x 500
   against its plain tier version and to its tier against the ``highest``
   ids, as B1 (yardstick ``torch.matmul`` + argmin in bf16), and
   ``KMeans.train`` at ``kmeans_precision`` highest, high and default:
   the tiers' objective drift from the ``highest`` fit (within
   ``KMEANS_DRIFT``), ids apart, ms an iteration beside ``highest``'s and
   peak memory, the sums kernel once an iteration (``kmeans_<tier>``); B2 at both tiers at the shapes its
   earlier design refused (``TIER_SHAPES``: K 16,384 at 110,272 rows, d 128,
   d 640 at 882,176 rows; ``tiers_b2_<tier>_<shape>``), each against its
   plain tier version as above, with its launch plan, and ``KMeans.train``
   at high at K 16,384 on 1.723M rows (``kmeans_high_k16384``); the split
   of the tiered search, B2 at 17.23M x 64 x 500 and B1 at K 16,384 in each
   ``ATK_TIER_SPLIT`` build (compiled beside phases 3-11) beside the
   default one (``[tiers split <build>]``); phase 8's pipeline on its audio with
   ``use_convolution=True`` (B2's sliced instance at d 640; 8 clips' tokens
   against the CPU) and with ``audio_backend="native"``,
   ``pcm_wire="i16"`` (centroids and tokens against phase 8's), each
   stage's seconds and launches (``pipeline_conv_*``,
   ``pipeline_native_*``); ``serve_bench`` for tokens and the lstm with
   the native decoder (``serve_bench_native_<branch>``) beside phase 11's
   python-decode numbers; ``[mirror]``: the reference pipeline's torch-CPU
   mirror (``tools/torch_mirror.py``, 16 threads on the host) on 4 of the
   clips at K 500, best of 3, beside B1's clips/s at ``highest``, its
   tokens held to B1's at ``highest`` on clip 0 (99% or more).

13. device-resident epochs (``train/device_epoch.py``) and the training
   options: the on-card exact mAP at 22,160 rows x 543 classes with tied
   scores against the host's exact mAP (1e-6), and the binned metric at
   8,192 bins against the host ``StreamingMAP`` (counts equal, 1e-6); then
   a resident synthetic token corpus of 22,160 + 2,048 clips of 1728 ids
   (uint16) and device epochs of the lstm (16 steps of 64 and its eval
   epoch: B3, B4), simple (a whole epoch), bert (``bert_full``, 8 steps of
   8 and an eval epoch of 256 clips through B5), and cnn on a bf16 spec
   corpus with the epoch gather: each with ms a step (host clock over the
   epoch), the card's busy ms a step under ``torch.profiler`` (the host
   gap a CUDA graph could remove), peak memory, the scalars read a
   epoch (2) and the launches, beside the family's streaming step of
   phases 6, 7 and 10 (``launches_by_path`` ``device_epoch_lstm``,
   ``device_eval_lstm``, ``device_eval_bert``); the full-width lstm with
   dropout through ``Trainer.run()`` 3 epochs device-resident against
   streaming (loss, mAP and weights within 1e-4); B3 at T 1728 in chunks
   of 64 and 216 from carries, bit-equal to one launch, and timed;
   ``lstm_remat_chunk`` 64 and 216 beside no remat at batch 64 (ms a step,
   peak memory, gradients; ``remat_lstm_<chunk>``) and
   ``transformer_remat`` at ``bert_full``'s widths, batch 8, dropout 0.1;
   one ``diagnostics_every=1`` epoch, its gradient-flow report against the
   CPU's.
14. ensembles and LR sweeps (``train/ensemble.py``): ``python -m
   audio_tokens_tpu_torch.train.ensemble`` (``ensemble.main``) with 4 lstm
   members on a token workspace of 512 + 64 clips, one epoch, its B3 and
   B4 launches (``ensemble_main_lstm``); then on
   ``tools/bench_training.py``'s synthetic corpus (8 batches + 256
   validation clips) K members against K 1, each with its epoch ms, the
   cost a member t_K / (K t_1), peak memory and launches: the full-width
   lstm with dropout 0.1 at K 4 (B3 and B4 launches K x the K 1 run's: the
   rule launches the kernel once a member; member 0 against a single
   ``DeviceEpochRunner`` of its seed within the phase-13 trajectory
   bounds; its first epoch under ``torch.cuda.set_sync_debug_mode(
   "error")`` but its one read of 2K + 1 scalars), the same with
   ``lstm_remat_chunk`` 216 (peak memory below, trajectory within 1e-4),
   simple at K 8 (the card's busy share under the profiler), bert
   (``bert_full``, batch 8) at K 2 (the eval epoch's B5 launches equal the
   K 1 run's: the members fold into B5's batch; one eval batch's
   probabilities against each member's own model, bf16 bound 2e-2), cnn
   at K 2 on a bf16 spec corpus (the conv batched by cuDNN); every line
   with the card's name and power limit (``launches_by_path``
   ``ensemble_*``).
15. multi-process and data parallel (``parallel/``), on phase 8's
   workspace: (a) two ranks of this script (``chip_smoke.py --dp-rank
   R 2 PORT DIR``, subprocesses sharing ``cuda:0`` over gloo, their output
   to files, both killed past a wait timeout) run the full-width lstm data
   parallel at global batch 64 (32 a rank) on ``tools/bench_training.py``'s
   synthetic corpus with dropout 0, 8 device-epoch steps and 4 streaming
   steps, then the staged pipeline on phase 8's audio (spectrograms, the
   tokenize stage with phase 8's centroids, the fused one (B1), a ``full``
   streaming fit, training); (b) one rank on NCCL (a world of one) takes
   one lstm step through the data-parallel path and a 2-step device epoch
   under ``torch.cuda.set_sync_debug_mode("error")`` but its one read;
   (c) with TF32 off the ranks' step losses and weights are held to one
   process on the card (1e-4 relative), each other (equal), their
   spectrograms and tokens to phase 8's files and their fused tokens to
   one process's (bit-equal, clip by clip), their centroids to one
   process's ``full`` fit (at most 1 ulp; the count apart printed), their
   training to one process's (1e-4, mAP 1e-3), (b)'s step to the plain
   step (1e-6). ``[dp lstm 2 ranks shared card]``, ``[dp pipeline 2
   ranks]``, ``[dp kmeans 2 ranks]``, ``[dp nccl 1 rank]`` give the ms a
   step (two ranks on one card: not a speed figure), the gradient
   all-reduce's bytes and ms, each stage's seconds and each rank's
   launches (``launches_by_path`` ``dp_*``: a rank's B3/B4 equal one
   process's at the same steps).
16. tensor and sequence parallelism and the batch-split entry points
   (``parallel/mesh.make_mesh``, ``models/transformer.py``), two ranks of
   this script sharing ``cuda:0`` over gloo (``--dp-rank``; their ms are
   of a time-sliced card, not speed figures): (a) bert at BERT's widths on
   TP 2 (6 heads a rank) and (b) on SP 2 (864 rows a rank), batch 8 with
   random lengths (the first 0): an eval pass (B5: the full window on 6
   heads; the query block against the gathered keys, f32 and bf16) and,
   in f32, one training step, each against one process on the card
   (logits 1e-4 f32 / 5e-2 bf16; the loss 1e-5 relative; each gradient
   at JAX's rtol 1e-4, atol 1e-6; the weights after AdamW within 2 lr /
   max |w|, what a gradient's sign apart moves, or C9's floor); C9: two
   one-process ``Trainer``s of phase 15's lstm and of (a)'s bert, their
   weights before a step, the first parameter whose gradient differs and
   the weights after, by default and under
   ``torch.use_deterministic_algorithms(True)`` in a process with
   ``CUBLAS_WORKSPACE_CONFIG``; B5's forward on the query block (rows 864..
   of 1728, batch 64, prefix lengths with a 0) against its plain version
   and the full window's rows, timed beside ``scaled_dot_product_attention``
   with the boolean mask (two records of its own); B5's backward pair on
   the query blocks (the two halves of the window, batch 8): the kernels
   against their plain versions, each block's dq against those rows of
   the full window's and the halves' dk and dv summed against the full
   window's, the second half timed beside the plain versions and sdpa's
   backward (four records); an eval-mode loss + backward of the bert on
   the B5 route on SP 2 (the query block's backward on each rank), f32
   against one process (the gradients' gap bounded as (b)'s weights) and
   bf16 (not bound); (c) ``serve_sharded``
   (lstm, f32 bert) and ``tokens_sharded`` on 8 clips against one process
   (tokens equal, probs 1e-6); (d) the full-width lstm ensemble K 2 over
   the 2 ranks against the unsharded one (phase 15's bounds, beside the
   JAX test's CPU tolerances); (e) the gradient-flow report
   (``Trainer.gradient_report``) of the f32 bert on TP 2 and on SP 2
   (every rank joins the weights, rank 0 reports on one unsharded model)
   against one process's report on the same weights and batch: the
   largest relative gap of each statistic within MP_REPORT_RTOL.
   ``[mp ...]`` and ``[c9 ...]`` lines, ``launches_by_path`` ``mp_*``.
17. the tools (``audio_tokens_tpu_torch/tools``): ``smoke_run`` (staged,
   the lstm, 1 epoch, 100 clips it writes; inference through
   ``ManualTester``: B1, B2, the sums, B3 and B4 must launch) and
   ``scale_run`` (fused, ``kmeans_mode="full"`` on the device feed,
   ``pcm_wire="i16"``, niter 5, 1 epoch, 1,024 clips: B1, B2 and the sums
   must launch); each stage's ``WIRE`` bytes equal the arithmetic of the
   arrays it moves, from the run's own counts, and where the stage has a
   device section its seconds are > 0 and at most the stage's wall time;
   the clustering rate scale_run measured (point-iterations a second over
   its device seconds); stage traces (``profile_dir``) of a staged
   spectrogram and tokenize run on 8 clips in this long-lived process,
   where the profiler drops a session's first kernel records: each trace
   with CUDA kernel events and a record of every launch of its stage, the
   tokenize trace naming B2's kernel; ``bench_spill --gb 1`` in the
   checkout's ``build/``, its cold leg called cold only where the cache
   advice drops a probe file's pages there, and ``bench_loader --n_clips
   2000``; the phase's own time.  The wav corpora are deleted after the
   phase.  ``[tools ...]`` lines, ``launches_by_path`` ``tools_*``.

A ``[time]`` line after each phase gives the script's clock.

Phases 8-12 decode with ``audio_backend="auto"``: the native decoder
(``data/native_loader.py``, built with g++ into ``build/native/``) where it
builds, as the JAX package.

The line before the last is the card as nvidia-smi reports it, the one
before that the per-kernel JSON record, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
nonzero before doing anything.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SR, CLIP_SECONDS, BATCH, VOCAB = 22050, 10.0, 64, 500
VOCAB_LARGE = 16384  # B2 streams these centroids (4 MB at d 64) through a ring
D_WIDE = 128  # mel bins past d 100: B2 walks each row in feature slices
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
STAGE_SUPERBATCH, STAGE_STOP = 262_144, 5  # the streaming stage's resume
STREAM_PIECE_CLIPS = 1000  # clips a host piece of the 17.23M-row stream
FEED_CLIPS = KMEANS_CLIPS  # the device feed at one default clustering batch
FEED_PREMADE = 4  # waveform batches made once and cycled through the feed
SPEC_ATOL, SPEC_RTOL = 5e-3, 1e-4  # dB: another DFT summation order
LOUD_DB, FLOOR_DB = -80.0, -100.0  # bins well above the 1e-10 power floor
CENT_ATOL = 1e-5   # one Lloyd step's centroids, other summation orders
LSTM_ATOL = 1e-4   # 1728 f32 steps, another summation order
DW_RTOL = 1e-4     # dw_hh: max abs error / max |dw_hh| (110,528-row sums)
PROBS_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
# phase 10: tools/bench_training.py's simple (hidden 768), cnn and baseline
# cases at batch 64 and T 1728; cnn and baseline at the default bf16
FAMILIES = {
    "simple": dict(model_type="simple", hidden_size=768),
    "cnn": dict(model_type="cnn", dataset_type="RawSTFTDataset"),
    "baseline": dict(model_type="baseline",
                     dataset_type="RawSTFTFlatDataset"),
}
# Predictor vs ServingProgram, one clip on one device: the JAX package's
# own bound for the pair (tests/test_export.py)
PREDICT_TOL = dict(rtol=2e-4, atol=1e-5)
# phase 11: a loaded kernel-form program vs the live one, the same kernels
# on the same inputs
EXPORT_PROBS_ATOL = 1e-5
PORTABLE_CLIPS = 8  # the portable lstm on the card: a scan of 1728 steps
# serve_bench's default corpus; 200 single requests, so that p99 is not
# the largest of a handful
SERVE_BENCH_CLIPS, SERVE_BENCH_LATENCY = 512, 200
# phase 13: device-resident epochs at full width on a synthetic resident
# corpus of the balanced train split's size (uint16 tokens: 76.6 MB) and a
# validation split of 32 batches; the lstm and cnn run EPOCH_STEPS steps,
# simple a whole epoch, bert BERT_STEPS at batch 8 and its eval epoch on
# BERT_EVAL clips; cnn on a bf16 spec corpus of SPEC_TRAIN clips (the
# epoch gather); then an epoch of twice the steps (the marginal step,
# without the epoch's fixed costs) and PROFILE_STEPS under the profiler
EPOCH_TRAIN, EPOCH_VAL = 22_160, 2_048
EPOCH_STEPS, BERT_STEPS, BERT_EVAL, PROFILE_STEPS = 16, 8, 256, 16
SPEC_TRAIN, SPEC_VAL = 2_048, 256
MAP_BINS, MAP_QUANT = 8192, 64  # the binned metric; scores on a 1/64 grid
# the device epoch against streaming at full width: 3 epochs of a corpus
# whose splits both end in a partial batch of 64
TRAJ_TRAIN, TRAJ_VAL, TRAJ_EPOCHS = 300, 70, 3
TRAJ_LOSS_RTOL, TRAJ_MAP_ATOL, TRAJ_PARAM_RTOL, TRAJ_PARAM_ATOL = (
    1e-4, 1e-4, 1e-4, 1e-6)
REMAT_CHUNKS, REMAT_STEPS = (64, 216), 4
DIAG_BATCH = 8  # the diagnostics batch, recomputed on the CPU at T 1728
# each family's streaming step in this run (phases 6, 7 and 10: median of
# steps 2..8, host clock, synchronized), beside phase 13's device epochs
STREAM_STEP_MS: dict = {}
# phase 14: ensembles on tools/bench_training.py's synthetic corpus of
# ENS_BATCHES batches + ENS_VAL validation clips (cnn: ENS_SPEC_BATCHES of
# bf16 spec rows + a batch), K members a family against K 1; the lstm K 4
# also with lstm_remat_chunk ENS_REMAT_CHUNK (trajectory within ENS_TOL)
ENS_BATCHES, ENS_VAL, ENS_SPEC_BATCHES = 8, 256, 4
ENS_K = {"lstm": 4, "simple": 8, "bert": 2, "cnn": 2}
ENS_REMAT_CHUNK, ENS_TOL = 216, 1e-4
# phase 15: data parallel over DP_WORLD ranks sharing cuda:0 (gloo), each a
# subprocess of this script killed past DP_WAIT_S: the full-width lstm at
# global batch 64 (32 a rank), DP_EPOCH_STEPS device-epoch steps then
# DP_STREAM_STEPS streaming steps on tools/bench_training.py's synthetic
# corpus (seed DP_SEED), dropout 0, held to one process on the same card
# within DP_RTOL (the gradient summed in another grouping); one NCCL rank's
# step within DP_NCCL_RTOL of the plain step
DP_WORLD, DP_EPOCH_STEPS, DP_STREAM_STEPS, DP_SEED = 2, 8, 4, 20
DP_WAIT_S, DP_GROUP_TIMEOUT_S, DP_ALLREDUCE_REPS = 900, 600, 5
DP_RTOL, DP_NCCL_RTOL, DP_MAP_ATOL = 1e-4, 1e-6, 1e-3
# phase 16: tensor and sequence parallelism over MP_WORLD ranks sharing
# cuda:0 (gloo): bert at BERT's widths, batch MP_BATCH of seed MP_SEED with
# random lengths (the first 0), reference_compat off so the lengths mask;
# the training steps in f32 (TF32 off: the tolerances below are f32's,
# another grouping of the same sums), the eval passes in f32 and bf16
MP_WORLD, MP_BATCH, MP_SEED, MP_SERVE_CLIPS = 2, 8, 30, 8
MP_LOSS_RTOL = 1e-5
MP_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # JAX's gradient tolerances
MP_LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
MP_PROBS_ATOL = 1e-6
# the weights after the TP and SP steps, relative to one process's: about
# ten times the largest reading (2.9e-6), a tenth of what one AdamW step
# of lr moves them by
MP_WEIGHT_RTOL = 3e-5
# the sharded ensemble: the full-width lstm, dropout 0.1, K 2 over the 2
# ranks on MP_ENS_BATCHES batches of 64 + MP_ENS_VAL validation clips,
# against the unsharded K 2 within MP_ENS_LOSS_RTOL / MP_ENS_MAP_ATOL,
# about ten times the readings (losses 0 apart, mAP 1.6e-6 to 1.7e-6);
# printed beside the JAX test's CPU tolerances (tests/test_ensemble.py:99),
# which the mAP meets only at about 1.0.  Beside it, where the difference
# comes from: a second unsharded K 2 (the run-to-run floor) and one
# process's K 1 of each member's seed (what a rank runs)
MP_ENS_BATCHES, MP_ENS_VAL = 4, 128
MP_ENS_LOSS_RTOL, MP_ENS_MAP_ATOL = 1e-5, 2e-5
MP_ENS_JAX_TOL = dict(rtol=1e-5, atol=1e-6)
# the gradient-flow report on TP 2 / SP 2 against one process: each
# statistic's relative gap (the CPU test's bound against JAX, rel 1e-4;
# below MP_REPORT_FLOOR the gap is taken over the floor)
MP_REPORT_RTOL, MP_REPORT_FLOOR = 1e-4, 1e-9
# phase 17: the tools at their own sizes
TOOLS_SMOKE_CLIPS, TOOLS_SCALE_CLIPS, TOOLS_SCALE_NITER = 100, 1024, 5
TOOLS_TRACE_CLIPS = 8
# B5's forward on a sequence rank's query block: the second half of the
# window against all of it
MP_T_Q = 864
# phase 12: the reference pipeline's torch-CPU mirror on 4 clips, its
# tokens held to B1's at highest on clip 0
MIRROR_CLIPS, MIRROR_AGREE = 4, 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def phase_done(n: int) -> None:
    """One line a phase: when it ended on the script's clock."""
    log(f"[time] phase {n} ended {time.perf_counter() - T_START:.1f} s into "
        "the script (host clock)")


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


def make_centroids(k: int = VOCAB, seed: int = 7, d: int = 64) -> np.ndarray:
    """Unit-normalized normals from a seed (tools/serve_bench.py's recipe:
    seed 7)."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((k, d)).astype(np.float32)
    return cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-10)


def write_labels(base: Path, rng, n_train: int = TRAIN_CLIPS,
                 n_val: int = VAL_CLIPS) -> dict:
    """The metadata of a synthetic corpus: ontology (543 classes), segment
    CSV (1-3 labels a clip) and split file of ``n_train`` + ``n_val``
    clips; returns the split."""
    n_cls = MODEL["num_classes"]
    (base / "metadata").mkdir(parents=True)
    (base / "output").mkdir()
    (base / "metadata" / "ontology.json").write_text(json.dumps([
        {"id": f"/m/c{i:03d}", "name": f"class {i}", "restrictions": []}
        for i in range(n_cls)]))
    ytids = [f"clip{i:05d}" for i in range(n_train + n_val)]
    lines = ["# synthetic", "# segments", "# YTID, start, end, labels"]
    for y in ytids:
        labs = rng.choice(n_cls, size=int(rng.integers(1, 4)), replace=False)
        lines.append(f'{y}, 0.0, 10.0, "'
                     + ",".join(f"/m/c{j:03d}" for j in sorted(labs)) + '"')
    (base / "metadata" / "balanced_train_segments.csv").write_text(
        "\n".join(lines) + "\n")
    split = {"train": ytids[:n_train], "validation": ytids[n_train:]}
    (base / "output" / "bal_train_data_split.json").write_text(
        json.dumps(split))
    return split


def write_token_corpus(base: Path, seed: int = 11,
                       n_train: int = TRAIN_CLIPS,
                       n_val: int = VAL_CLIPS) -> None:
    """A seeded synthetic corpus in the layout the trainer reads:
    ``write_labels``' metadata and uint16 token ids per clip under
    tokenized_audio/{train,validation}/."""
    rng = np.random.default_rng(seed)
    split = write_labels(base, rng, n_train, n_val)
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


def loss_and_grads(model, x, y, w, train: bool):
    """One weighted-BCE loss + backward of ``model`` on its device (training
    or eval mode) -> (loss, {name: gradient on the host})."""
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    d = next(model.parameters()).device
    model.train(train)
    model.zero_grad(set_to_none=True)
    loss = weighted_bce(model(x.to(d)), y.to(d), w.to(d))
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def card_vs_cpu_grads(tag: str, card_model, cpu_model, x, y, w,
                      train: bool, f32_ref=None):
    """One weighted-BCE loss + backward on each side (training or eval
    mode); the losses within LOSS_ATOL and every gradient within
    GRAD_ATOL + GRAD_RTOL * |CPU's|.  For bf16 models ``f32_ref`` is the
    CPU's (loss, gradients) of the same weights in f32: both sides round
    every layer to 8 bits, so the card may be as far from the CPU's bf16
    answer as that answer is from the f32 one, and each bound becomes twice
    the CPU's own bf16 error (largest over the tensor) plus the f32 bound.
    Returns the CPU's (loss, gradients)."""
    card, cpu = (loss_and_grads(m, x, y, w, train)
                 for m in (card_model, cpu_model))
    loss_err = abs(card[0] - cpu[0])
    loss_tol = LOSS_ATOL
    if f32_ref is not None:
        loss_tol += 2 * abs(cpu[0] - f32_ref[0])
    worst, bound = {}, {}
    for name, ref in cpu[1].items():
        diff = (card[1][name] - ref).abs()
        if f32_ref is None:
            bound[name] = GRAD_ATOL
            over = float((diff - GRAD_RTOL * ref.abs()).max())
        else:
            bound[name] = GRAD_ATOL + 2 * float(
                (ref - f32_ref[1][name]).abs().max())
            over = float(diff.max())
        worst[name] = (float(diff.max()), over)
    rule = (f"atol {GRAD_ATOL} + rtol {GRAD_RTOL}" if f32_ref is None
            else "bound 2x the CPU bf16's own error + " + str(GRAD_ATOL))
    log(f"{tag} {len(x)} rows, loss card {card[0]:.8f} vs CPU "
        f"{cpu[0]:.8f} (|diff| {loss_err:.3e}, bound {loss_tol:.3e}); "
        f"largest gradient errors: "
        + ", ".join(f"{n} {e:.3e}" + (f" of {bound[n]:.3e}"
                                      if f32_ref is not None else "")
                    for n, (e, _) in sorted(
                        worst.items(), key=lambda kv: -kv[1][0])[:4])
        + f" ({rule})")
    if not loss_err <= loss_tol:
        raise AssertionError(f"{tag} loss differs by {loss_err:.3e}")
    bad = {n: e for n, (e, over) in worst.items() if over > bound[n]}
    if bad:
        raise AssertionError(f"{tag} gradients differ from the CPU: {bad}")
    return cpu


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


def check_served(tokens, n_valid, probs, b: int, frames_max: int,
                 classes: int, vocab: int = VOCAB) -> None:
    """A served batch's shapes, token range and probabilities in [0, 1]."""
    import torch

    if tuple(tokens.shape) != (b, frames_max):
        raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
    if tuple(probs.shape) != (b, classes) or n_valid.numel() != b:
        raise AssertionError(f"probs {tuple(probs.shape)}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
        raise AssertionError("token id out of range")
    if not (torch.isfinite(probs).all() and probs.min() >= 0
            and probs.max() <= 1):
        raise AssertionError("probs not finite in [0, 1]")


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


def clock_stages(stages, kernels, seconds: dict, launches: dict,
                 made: dict | None = None):
    """Wrap each stage class's ``run`` so that it records its seconds (host
    clock, synchronized), the launches of ``kernels`` made inside it and,
    into ``made``, the stage object; returns the function that restores
    the classes."""
    import torch

    saved = {cls: cls.__dict__.get("run") for cls in stages}
    for cls in stages:
        def run(self, _run=cls.run, _name=cls.__name__):
            if made is not None:
                made[_name] = self
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


def f64_spectrogram(cfg, ytid: str) -> np.ndarray:
    """A clip's (n_mels, frames) log-mel through the port's frontend in
    float64 on the CPU: the reference for where the card and the CPU part
    in float32."""
    import torch

    from audio_tokens_tpu_torch.data.audio_io import (decode_clip,
                                                      find_audio_file)
    from audio_tokens_tpu_torch.ops.mel import MelFrontend

    fe = MelFrontend("cpu", cfg.common_sr, cfg.n_mels, cfg.n_fft,
                     cfg.hop_length, cfg.clip_samples)
    fe._basis, fe._fbank = fe._basis.double(), fe._fbank.double()
    batch, lengths = fe.prepare_batch(
        [decode_clip(cfg, find_audio_file(cfg, ytid))])
    spec = fe(torch.from_numpy(batch).double())[0]
    return spec[:, : 1 + int(lengths[0]) // cfg.hop_length].numpy()


def agreeing_centroid_error(ids, ids_ref, cents, cents_ref) -> float:
    """Largest centroid difference over the clusters whose members are the
    same in both assignments."""
    import torch

    moved = torch.cat([ids[ids != ids_ref], ids_ref[ids != ids_ref]])
    same = torch.ones(cents.shape[0], dtype=torch.bool)
    same[moved.long()] = False
    return float((cents[same] - cents_ref[same]).abs().max())


class Interrupt(Exception):
    """Stops a streaming fit after a chosen iteration's checkpoint."""


def stream_stage(records: list, cfg, base: Path, dev, frames: int) -> None:
    """The clustering stage's streaming fit on phase 8's workspace:
    uninterrupted, then stopped after iteration STAGE_STOP and resumed
    from its checkpoint (``incremental=True``), which must give the same
    centroids bit for bit."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.ops.kmeans import DEFAULT_CHUNK
    from audio_tokens_tpu_torch.processors import ClusterCreator

    scfg = dataclasses.replace(
        cfg, kmeans_mode="full", kmeans_streaming="always",
        kmeans_superbatch_rows=STAGE_SUPERBATCH, incremental=True,
        centroids_path=base / "output" / "stream_centroids.npy")
    capacity = max(1, STAGE_SUPERBATCH // DEFAULT_CHUNK) * DEFAULT_CHUNK
    n_sb = -(-frames // capacity)
    runs, launches, seconds = [], [], []
    tier_sums64.launches = 0
    for stop in (None, STAGE_STOP, None):
        cc = ClusterCreator(scfg, dev)
        if stop is not None:
            save = cc._save_kmeans_checkpoint

            def save_then_stop(it, c, o, _save=save, _stop=stop):
                _save(it, c, o)
                if it == _stop:
                    raise Interrupt

            cc._save_kmeans_checkpoint = save_then_stop
        torch.cuda.synchronize()
        before = vq_argmin.launches
        t0 = time.perf_counter()
        try:
            runs.append(cc.run())
        except Interrupt:
            ckpt = np.load(cc._kmeans_ckpt_path())
            if int(ckpt["iter"]) != stop:
                raise AssertionError(f"checkpoint at {ckpt['iter']}, not "
                                     f"{stop}")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(vq_argmin.launches - before)
    want = [n_sb * cfg.niter, n_sb * STAGE_STOP, n_sb * (cfg.niter - STAGE_STOP)]
    if launches != want or tier_sums64.launches != sum(want):
        raise AssertionError(f"streaming stage launched B2 {launches} times "
                             f"and the sums {tier_sums64.launches}, not "
                             f"{want}")
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("the resumed streaming stage differs from the "
                             "uninterrupted one")
    if cc._kmeans_ckpt_path().exists():
        raise AssertionError("the streaming fit's checkpoint was not deleted")
    records[1]["launches_by_path"]["pipeline_cluster_stream"] = sum(launches)
    sums_record(records)["launches_by_path"]["pipeline_cluster_stream"] = \
        tier_sums64.launches
    log(f"[pipeline stream] ClusterCreator kmeans_mode=full, streaming "
        f"always, {frames} frames in {n_sb} super-batches of "
        f"{capacity}, {cfg.niter} iterations: uninterrupted "
        f"{seconds[0]:.2f} s, stopped after iteration {STAGE_STOP} "
        f"{seconds[1]:.2f} s, resumed {seconds[2]:.2f} s (host clock, "
        f"synchronized); centroids bit-equal; B2 launches {launches}")


def kmeans_rows(cfg, dev):
    """The unit rows of one default clustering batch (KMEANS_CLIPS clips:
    17.23M x 64 at the package defaults), made on the card from a seed."""
    import torch

    n = KMEANS_CLIPS * (1 + cfg.clip_samples // cfg.hop_length)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    x = torch.randn((n, cfg.n_mels), generator=gen, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10
    return x


def stage_config(base: Path, **over):
    """Phase 8's configuration for the workspace ``base`` (the package
    defaults, the full-width lstm, batch 64, 1 epoch): made anew for each
    workspace, since a config derives its paths from ``base_dir`` once."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    return AudioTokensConfig(base_dir=str(base), **MODEL,
                             training_batch_size=B_LSTM, epochs=1, **over)


def pipeline_phase(records: list, dev, base: Path):
    """Phase 8: ``run_pipeline.main`` on a wav workspace written to
    ``base`` at the package defaults, its results against the CPU, then
    K-means at real size; returns the run's config and centroids."""
    import torch

    from audio_tokens_tpu_torch import run_pipeline
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_kmeans import (tier_sums64,
                                                        tier_sums64_plain)
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
               lstm_sequence_bwd, tier_sums64)
    stages = (SpectrogramGenerator, ClusterCreator, SpecTokenizer,
              ModelTrainer)
    sums_rec = dict(
        name=SUMS_NAME, route="cuda",
        source="audio_tokens_tpu_torch/csrc/kmeans.cu",
        replaces="audio_tokens_tpu/ops/kmeans.py:90 (the one-hot product "
        "inside _lloyd_stats; no Pallas kernel)", launches_by_path={})
    records.append(sums_rec)
    t0 = time.perf_counter()
    split = write_audio_corpus(base)
    write_s = time.perf_counter() - t0
    cfg = stage_config(base)
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
    log("[pipeline] launches B1, B2, B3, B4, sums by stage (training: "
        "a device-resident epoch, the default route, the corpus packing "
        "in its seconds): "
        + "; ".join(f"{n} {launches[n]}" for n in names)
        + f"; whole run {total}")
    b2_cluster = launches["ClusterCreator"][1]
    sums_cluster = launches["ClusterCreator"][4]
    b2_tokenize = launches["SpecTokenizer"][1]
    b3_train, b4_train = launches["ModelTrainer"][2:4]
    if frames != TRAIN_CLIPS * (1 + cfg.clip_samples // cfg.hop_length):
        raise AssertionError(f"train corpus has {frames} frames")
    if cents.shape != (cfg.vocab_size, cfg.n_mels) or \
            cents.dtype != np.float32:
        raise AssertionError(f"centroids {cents.shape} {cents.dtype}")
    if (b2_cluster < cfg.niter or b2_tokenize < 2 or b3_train < 1
            or b4_train < 1 or sums_cluster != b2_cluster):
        raise AssertionError(f"a kernel of the pipeline launched too "
                             f"rarely: {launches}")
    if not (np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0):
        raise AssertionError(f"val loss {val_loss}, mAP {val_metrics}")
    records[1]["launches_by_path"].update(
        pipeline_cluster=b2_cluster, pipeline_tokenize=b2_tokenize)
    sums_rec["launches_by_path"]["pipeline_cluster"] = sums_cluster
    records[2]["launches_by_path"]["pipeline_train"] = b3_train
    records[3]["launches_by_path"]["pipeline_train"] = b4_train

    # the card's results against the CPU: spectrograms from the
    # decoded waves (clip 0 stereo, clip 5 resampled), one Lloyd step
    # from the saved centroids, tokens from the saved centroids
    spec_err, loud_err, spec_at = 0.0, 0.0, None
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
        at = np.unravel_index(diff.argmax(), diff.shape)
        if diff[at] >= spec_err:
            spec_err = float(diff[at])
            spec_at = (y, *map(int, at), float(spec[at]), float(card[at]),
                       float(spec[:, at[1]].max()))
        loud = spec > LOUD_DB
        if loud.any():
            loud_err = max(loud_err, float(diff[loud].max()))
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
    ref64 = f64_spectrogram(cfg, spec_at[0])[spec_at[1:3]]
    log(f"[pipeline reference] spectrogram gap: largest {spec_err:.3e} "
        f"dB at {spec_at[0]} mel bin {spec_at[1]}, frame {spec_at[2]}, "
        f"where the CPU has {spec_at[3]:.4f} dB (card {spec_at[4]:.4f}, "
        f"the frame's loudest bin {spec_at[5]:.4f} dB, the same frontend "
        f"in f64 on the CPU {ref64:.4f}: card {spec_at[4] - ref64:+.3e}, "
        f"CPU {spec_at[3] - ref64:+.3e}); largest over bins above "
        f"{LOUD_DB:g} dB {loud_err:.3e} dB (the power floor is "
        f"{FLOOR_DB:g} dB)")
    log(f"[pipeline reference] CPU vs card: 8 spectrograms max abs err "
        f"{spec_err:.3e} dB (atol {SPEC_ATOL} + rtol {SPEC_RTOL}); one "
        f"Lloyd step over {x.shape[0]} frames of 64 clips: ids "
        f"{frac:.2e} disagree (gap {gap:.3e}), centroids max abs err "
        f"{cent_err:.3e} (atol {CENT_ATOL}), objective card "
        f"{card[2]:.6f} vs CPU {cpu[2]:.6f}; tokens of 8 clips "
        f"{tok_frac:.2e} disagree (gap {tok_gap:.3e})")
    del x, c, tok_frames, tok_card, step
    stream_stage(records, cfg, base, dev, frames)

    # K-means at the size of one default clustering batch
    x = kmeans_rows(cfg, dev)
    n = x.shape[0]
    fits, fit_s = [], []
    points_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    tier_sums64.launches = 0
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
    fit_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fit_sums = tier_sums64.launches
    if fit_sums != 2 * cfg.niter:
        raise AssertionError(f"two fits launched the sums {fit_sums} times")
    if not (torch.equal(fits[0].centroids, fits[1].centroids)
            and fits[0].obj == fits[1].obj):
        raise AssertionError("two card K-means fits differ")
    c = fits[0].centroids
    assign_ms = cuda_ms(lambda: km.assign(x, c), 3)
    ids = km.assign(x, c)
    sums_ms = cuda_ms(lambda: km.cluster_sums(x, ids, cfg.vocab_size), 3)
    split = sums_split(x, ids, cfg.vocab_size)
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
    # the sums kernel at each tier against its plain version; yardstick
    # one index_add_ (f32 atomics: another order each run)
    acc = torch.zeros_like(c)
    idx = ids.long()
    index_add_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, x), 3)
    del acc, idx
    # the sums read each row and id once and write (parts, K, d) f64
    sums_by_tier = {}
    for tier in ("highest", "bf16x3", "default"):
        parts = 2 if tier == "bf16x3" else 1
        err, rel, frac, ulps = sums_check(x, ids, cfg.vocab_size, tier)
        k_ms = cuda_ms(lambda: tier_sums64(x, ids, cfg.vocab_size, tier), 5)
        p_ms = cuda_ms(lambda: tier_sums64_plain(x, ids, cfg.vocab_size,
                                                 tier), 2)
        b = bound_of(x.numel() * parts, x.numel() * 4 + n * 4
                     + parts * c.numel() * 8)
        sums_by_tier[tier] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
                                  bound_by=b[1], max_abs_err=err,
                                  rel_err=rel, f32_apart=frac,
                                  max_ulps=ulps)
        log(f"[kmeans sums] {tier}: tier_sums64 (csrc/kmeans.cu, sort "
            f"included) {k_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), plain "
            f"version {p_ms:.3f} ms; against the plain version: f64 max abs "
            f"err {err:.3e}, within {rel:.2e} of the entries' sum |x| (limit "
            f"1e-12), f32 sums "
            f"{frac:.2e} apart (limit 1e-4), at most {ulps} ulp; index_add_ "
            f"(f32 atomics) {index_add_ms:.3f} ms")
    torch.cuda.empty_cache()
    lib_ms = cuda_ms(lambda: vq_argmin_plain(x, c, False, chunk=1 << 18), 2)
    lib_frac, lib_gap = check_near_ties(
        x, c, ids, vq_argmin_plain(x, c, False, chunk=1 << 18))
    flop = 2 * n * cfg.vocab_size * cfg.n_mels
    nbytes = x.numel() * 4 + n * 4 + c.numel() * 4
    assign_b = bound_of(flop, nbytes)
    sums_b = (sums_by_tier["highest"]["bound_ms"],
              sums_by_tier["highest"]["bound_by"])
    # the one-hot GEMM does as many operations as the assignment
    onehot_b = bound_of(flop, nbytes)
    iter_ms = min(fit_s) / cfg.niter * 1e3
    rate = n * cfg.niter / min(fit_s)
    log(f"[kmeans] {n} unit rows x {cfg.n_mels}, vocab {cfg.vocab_size}, "
        f"{cfg.niter} iterations: KMeans.train {fit_s[0]:.3f} s and "
        f"{fit_s[1]:.3f} s (host clock, synchronized), bit-equal; "
        f"{iter_ms:.2f} ms an iteration, {rate / 1e6:.1f}M point-iterations/s; "
        f"assignment (B2) {assign_ms:.3f} ms, bound {assign_b[0]:.3f} ms "
        f"({assign_b[1]}, {flop / 1e12:.3f} TFLOP f32); sums (the sums "
        f"kernel, tiles of {km.SEGMENT_BLOCK} sorted rows) {sums_ms:.3f} "
        f"ms, bound {sums_b[0]:.3f} ms ({sums_b[1]}); the one-hot GEMM "
        f"in chunks of {1 << 16} instead {onehot_ms:.3f} ms (bound "
        f"{onehot_b[0]:.3f} ms, {onehot_b[1]}; max abs diff "
        f"{onehot_err:.3e}); rest of the iteration "
        f"{iter_ms - assign_ms - sums_ms:.3f} ms; yardstick torch.matmul + "
        f"argmin in chunks of {1 << 18} (TF32 off) {lib_ms:.3f} ms, ids "
        f"{lib_frac:.2e} disagree with B2's (gap {lib_gap:.3e}); sums "
        f"launches {fit_sums}")
    log(f"[kmeans] peak device memory of the fits {fit_peak_gb:.3f} GB "
        f"(max_memory_allocated), {fit_peak_gb - points_gb:.3f} GB beside "
        f"the {points_gb:.3f} GB of points; the sums' {sums_ms:.3f} ms by "
        f"part (CUDA events, each alone): stable sort of the ids "
        f"{split['sort_ms']:.3f} ms, the clusters' bounds (searchsorted) "
        f"{split['bounds_ms']:.3f} ms, the kernel's two passes (the rest) "
        f"{sums_ms - sum(split.values()):.3f} ms")
    records[1]["kmeans_17M"] = dict(
        rows=n, iteration_ms=iter_ms, point_iters_per_s=rate,
        assign_ms=assign_ms, assign_bound_ms=assign_b[0], sums_ms=sums_ms,
        sums_bound_ms=sums_b[0], onehot_sums_ms=onehot_ms,
        onehot_sums_bound_ms=onehot_b[0], matmul_argmin_ms=lib_ms,
        peak_gb=fit_peak_gb, points_gb=points_gb,
        sums_passes_ms=sums_ms - sum(split.values()), **split)
    top = sums_by_tier["highest"]
    sums_rec.update(
        max_abs_err=top["max_abs_err"], rel_err=top["rel_err"],
        ms=top["ms"], plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"], bound_by=top["bound_by"],
        library_ms=index_add_ms, shapes=f"N {n}, d {cfg.n_mels}, K "
        f"{cfg.vocab_size}", by_tier=sums_by_tier)
    sums_rec["launches_by_path"]["kmeans_17M"] = fit_sums
    del ids, sums
    stream_phase(records, cfg, dev, x, c)
    del x, fits, c
    torch.cuda.empty_cache()
    return cfg, cents


def shared_workspace(base: Path, name: str, shuffle: bool = False) -> Path:
    """A workspace of its own under phase 8's ``base``, reading its audio
    (a symlink) and metadata and split (copies; with ``shuffle`` each
    split's clips in a seeded random order, so that a staged spectrogram
    stage puts each clip at another row of another batch than the fused
    mode's sorted batches)."""
    import shutil

    ws = base / name
    shutil.copytree(base / "metadata", ws / "metadata")
    (ws / "output").mkdir()
    split = json.loads((base / "output" / "bal_train_data_split.json")
                       .read_text())
    if shuffle:
        rng = np.random.default_rng(13)
        split = {k: [v[i] for i in rng.permutation(len(v))]
                 for k, v in split.items()}
    (ws / "output" / "bal_train_data_split.json").write_text(
        json.dumps(split))
    (ws / "audioset").symlink_to(base / "audioset")
    return ws


def token_flips(tag: str, spec_root: Path, tok_roots, split: dict,
                cents: np.ndarray) -> dict:
    """The token files of two runs (``tok_roots``) over every clip of both
    splits, held under the near-tie rule on the unit frames of the
    spectrograms under ``spec_root``: logs and returns the frames apart,
    the largest float64 score gap and where it sits (clip, frame, both
    ids); raises past the rule or if the artifact sets differ."""
    import torch

    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    feats, ids, clips = [], ([], []), []
    for name, ytids in split.items():
        ytids = sorted(ytids)
        for root in tok_roots:
            if sorted(f.stem for f in (root / name).glob("*.npy")) != ytids:
                raise AssertionError(f"{tag}: {root / name} holds other "
                                     f"clips")
        for y in ytids:
            spec = np.load(spec_root / name / f"{y}.npy")
            for side, root in zip(ids, tok_roots):
                toks = np.load(root / name / f"{y}.npy")
                if toks.dtype != np.int64 or toks.shape != (spec.shape[1],):
                    raise AssertionError(f"{tag}: {y} tokens {toks.shape} "
                                         f"{toks.dtype}")
                side.append(toks)
            feats.append(spec.T)
            clips.append((y, spec.shape[1]))
    x = l2_normalize(torch.from_numpy(np.concatenate(feats)))
    a, b = (torch.from_numpy(np.concatenate(side)) for side in ids)
    c = torch.from_numpy(cents)
    rows = (a != b).nonzero().flatten()
    out = dict(frames=int(a.numel()), flips=int(rows.numel()), max_gap=0.0,
               at=None)
    if rows.numel():
        f, cd = x[rows].double(), c.double()

        def score(i):
            return (cd[i] * cd[i]).sum(1) - 2.0 * (f * cd[i]).sum(1)

        gaps = (score(a[rows]) - score(b[rows])).abs()
        j = int(gaps.argmax())
        row = int(rows[j])
        starts = np.cumsum([0] + [n for _, n in clips])
        clip = int(np.searchsorted(starts, row, "right")) - 1
        out.update(max_gap=float(gaps[j]),
                   at=(clips[clip][0], row - int(starts[clip]), int(a[row]),
                       int(b[row])))
    log(f"[fused tokens] {tag}: {out['flips']} of {out['frames']} frames of "
        f"{len(clips)} clips apart, largest float64 score gap "
        f"{out['max_gap']:.3e}" + (f" at {out['at'][0]} frame "
                                   f"{out['at'][1]} (ids {out['at'][2]} vs "
                                   f"{out['at'][3]})" if out["at"] else ""))
    check_near_ties(x, c, a, b)
    return out


def fused_phase(records: list, dev, base: Path, cfg, cents) -> None:
    """Phase 9: ``run_pipeline.main`` with ``fused_pipeline=True`` on
    phase 8's audio, in ``batch_warm_start`` and in ``full`` beside a staged
    ``full`` run, held to the staged runs; then the device feed at one
    default clustering batch."""
    import torch

    from audio_tokens_tpu_torch import run_pipeline
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.processors import (ClusterCreator,
                                                   ModelTrainer,
                                                   SpecTokenizer,
                                                   SpectrogramGenerator)

    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd,
               lstm_sequence_bwd, tier_sums64)
    stages = (SpectrogramGenerator, ClusterCreator, SpecTokenizer,
              ModelTrainer)
    names = [c.__name__ for c in stages]
    sums_paths = sums_record(records)["launches_by_path"]
    split = json.loads(Path(cfg.split_file).read_text())
    bs = cfg.device_batch_size
    train_batches = -(-len(split["train"]) // bs)
    val_batches = -(-len(split["validation"]) // bs)

    def run(name: str, shuffle: bool = False, **over):
        ws = shared_workspace(base, name, shuffle)
        rcfg = AudioTokensConfig(base_dir=str(ws), **MODEL,
                                 training_batch_size=B_LSTM, epochs=1, **over)
        seconds, launches, made = {}, {}, {}
        restore = clock_stages(stages, kernels, seconds, launches, made)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            val_loss, val_metrics = run_pipeline.main(rcfg, dev)
        finally:
            restore()
        run_s = time.perf_counter() - t0
        if not (np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0):
            raise AssertionError(f"{name}: val loss {val_loss}, mAP "
                                 f"{val_metrics}")
        flags = ", ".join(f"{k}={v}" for k, v in over.items())
        log(f"[fused pipeline] {name} ({flags}): "
            + ", ".join(f"{n} {seconds[n]:.2f} s" for n in names
                        if n in seconds)
            + f" (host clock, synchronized); main() {run_s:.2f} s; val loss "
            f"{val_loss:.6f}, val mAP {val_metrics['mAP']:.6f}; launches "
            "B1, B2, B3, B4, sums by stage: "
            + "; ".join(f"{n} {launches[n]}" for n in names
                        if n in launches))
        return rcfg, seconds, launches, made["ClusterCreator"], run_s

    # 9.1 batch_warm_start: B1 tokenizes every clip
    fcfg, _, fl, fcc, _ = run("fused", fused_pipeline=True)
    if Path(fcfg.dest_spec_path).exists():
        raise AssertionError("the fused run wrote spectrograms")
    got = np.load(fcfg.centroids_path)
    if not np.array_equal(got, cents):
        raise AssertionError(f"fused centroids differ from phase 8's by "
                             f"{np.abs(got - cents).max():.3e}")
    b1_tok, b2_tok = fl["SpecTokenizer"][:2]
    if (fcc.used_device_feed or b1_tok != train_batches + val_batches
            or b2_tok != 0 or fl["ClusterCreator"][1] < cfg.niter
            or fl["ClusterCreator"][4] != fl["ClusterCreator"][1]
            or min(fl["ModelTrainer"][2:4]) < 1):
        raise AssertionError(f"fused batch_warm_start launches {fl}")
    flips = token_flips("fused batch_warm_start (B1) vs phase 8 (MelFrontend "
                        "+ B2)", Path(cfg.dest_spec_path),
                        (Path(fcfg.dest_tokenized_path),
                         Path(cfg.dest_tokenized_path)), split, cents)
    records[0]["launches_by_path"]["pipeline_fused_tokenize"] = b1_tok
    records[0]["c2_b1_vs_staged_tokens"] = flips
    records[1]["launches_by_path"]["pipeline_fused_cluster"] = \
        fl["ClusterCreator"][1]
    sums_paths["pipeline_fused_cluster"] = fl["ClusterCreator"][4]
    records[2]["launches_by_path"]["pipeline_fused_train"] = \
        fl["ModelTrainer"][2]
    records[3]["launches_by_path"]["pipeline_fused_train"] = \
        fl["ModelTrainer"][3]
    log(f"[fused pipeline] batch_warm_start: no spectrograms written; "
        f"centroids bit-equal to phase 8's; B1 {b1_tok} launches in the "
        f"tokenize stage ({train_batches} train + {val_batches} validation "
        f"batches of {bs})")

    # 9.2 full: the device feed and the resident handoff, beside a staged
    # full fit of the same rows
    scfg, ss, sl, _, s_run = run("staged_full", shuffle=True,
                                 kmeans_mode="full", kmeans_streaming="never")
    fcfg, fs, fl, fcc, f_run = run("fused_full", kmeans_mode="full",
                                   fused_pipeline=True)
    if not fcc.used_device_feed or fcc.resident_frames is not None:
        raise AssertionError("the fused full fit did not take the device "
                             "feed, or kept its frames")
    b1_tok, b2_tok = fl["SpecTokenizer"][:2]
    if b1_tok != val_batches or b2_tok != 1 or \
            fl["ClusterCreator"][1] != cfg.niter or \
            fl["ClusterCreator"][4] != cfg.niter or \
            sl["ClusterCreator"][4] != sl["ClusterCreator"][1]:
        raise AssertionError(f"fused full launches {fl}: the train split "
                             f"did not come from the resident frames")
    got, ref = np.load(fcfg.centroids_path), np.load(scfg.centroids_path)
    if not np.array_equal(got, ref):
        raise AssertionError(f"fused full centroids differ from the staged "
                             f"full fit's by {np.abs(got - ref).max():.3e}")
    full_flips = token_flips(
        "fused full (resident B2 + B1) vs staged full",
        Path(scfg.dest_spec_path), (Path(fcfg.dest_tokenized_path),
                                    Path(scfg.dest_tokenized_path)),
        split, ref)
    records[0]["launches_by_path"]["pipeline_fused_full_tokenize"] = b1_tok
    records[1]["launches_by_path"].update(
        pipeline_fused_full_cluster=fl["ClusterCreator"][1],
        pipeline_fused_resident=b2_tok,
        pipeline_full_cluster=sl["ClusterCreator"][1],
        pipeline_full_tokenize=sl["SpecTokenizer"][1])
    sums_paths.update(pipeline_fused_full_cluster=fl["ClusterCreator"][4],
                      pipeline_full_cluster=sl["ClusterCreator"][4])
    for rec, kernel in ((records[2], 2), (records[3], 3)):
        rec["launches_by_path"].update(
            pipeline_fused_full_train=fl["ModelTrainer"][kernel],
            pipeline_full_train=sl["ModelTrainer"][kernel])
    records[1]["pipeline_full_seconds"] = dict(
        staged=dict(ss, main=s_run), fused=dict(fs, main=f_run),
        token_flips=full_flips)
    log(f"[fused pipeline] full: the device feed engaged, centroids "
        f"bit-equal to the staged full fit's (whose spectrogram stage "
        f"batched the clips in a shuffled split order); the train split "
        f"from the resident frames (B2 {b2_tok}), validation through B1 "
        f"({b1_tok})")
    del fcc
    feed_phase(records, cfg, dev)


def feed_phase(records: list, cfg, dev) -> None:
    """The device feed at one default clustering batch: FEED_CLIPS
    synthetic ten-second clips fed from memory through
    ``ClusterCreator._feed_batch`` (cycling FEED_PREMADE batches), then
    the fit on the buffer's view; its first batch's rows against the
    host-mediated route's, its peak memory against the buffer plus phase
    8's in-memory fit overhead (1 GB of slack)."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.ops.vq import l2_normalize
    from audio_tokens_tpu_torch.processors import (ClusterCreator,
                                                   SpectrogramGenerator)
    from audio_tokens_tpu_torch.processors import cluster_creator

    fcfg = dataclasses.replace(cfg, fused_pipeline=True, kmeans_mode="full")
    cc = ClusterCreator(fcfg, dev)
    gen = SpectrogramGenerator(fcfg, dev)
    bs = cfg.device_batch_size
    premade = []
    for i in range(FEED_PREMADE):
        waves = make_clips(bs, 100_000 + bs * i)
        premade.append((waves, *gen.frontend.prepare_batch(waves)))
    batch_bytes = premade[0][1].nbytes
    copy_ms = cuda_ms(lambda: torch.from_numpy(premade[0][1]).to(dev), 5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    buffer = torch.empty((cc._feed_capacity_rows(FEED_CLIPS), cfg.n_mels),
                         dtype=torch.float32, device=dev)
    offset, manifest, wave_bytes = 0, {}, 0
    n_batches = -(-FEED_CLIPS // bs)
    t0 = time.perf_counter()
    for j in range(n_batches):
        _, batch, lengths = premade[j % FEED_PREMADE]
        live = min(bs, FEED_CLIPS - j * bs)
        if live < bs:
            lengths = np.where(np.arange(bs) < live, lengths, -1)
        ytids = [f"feed{j * bs + r:05d}" if r < live else None
                 for r in range(bs)]
        offset = cc._feed_batch(gen.frontend, buffer, offset, batch,
                                lengths.astype(np.int32), ytids, manifest)
        wave_bytes += batch_bytes
        if j == 0:
            first = offset
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    if offset != FEED_CLIPS * cfg.frames_per_clip or len(manifest) != \
            FEED_CLIPS:
        raise AssertionError(f"the feed filled {offset} rows of "
                             f"{len(manifest)} clips")
    specs = [spec.T for _, spec in gen._specs_for_batch(
        [(f"feed{r:05d}", w) for r, w in enumerate(premade[0][0])])]
    host = l2_normalize(torch.from_numpy(np.concatenate(specs)).to(dev))
    if not torch.equal(buffer[:first], host):
        raise AssertionError(f"the feed's first batch differs from the host "
                             f"route's by "
                             f"{float((buffer[:first] - host).abs().max()):.3e}")
    del host, specs
    feed_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    before = vq_argmin.launches
    tier_sums64.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centroids, obj = cluster_creator.kmeans_fit(
        buffer, cfg.vocab_size, cfg.niter, seed=cfg.random_seed,
        n_valid=offset)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = vq_argmin.launches - before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    buffer_gb = buffer.numel() * 4 / 1e9
    k17 = records[1]["kmeans_17M"]
    limit_gb = buffer_gb + (k17["peak_gb"] - k17["points_gb"]) + 1.0
    if launches != cfg.niter or tier_sums64.launches != cfg.niter or \
            not torch.isfinite(centroids).all():
        raise AssertionError(f"the feed's fit launched B2 {launches} times, "
                             f"the sums {tier_sums64.launches}")
    if peak_gb > limit_gb:
        raise AssertionError(f"the feed's fit peaked at {peak_gb:.3f} GB "
                             f"over {base_gb:.3f} GB, past {limit_gb:.3f}: "
                             f"the view was copied")
    log(f"[fused feed] {FEED_CLIPS} clips of {CLIP_SECONDS:g} s in "
        f"{n_batches} batches of {bs} (cycling {FEED_PREMADE} made in "
        f"memory) through ClusterCreator._feed_batch: {offset} rows into a "
        f"({buffer.shape[0]}, {buffer.shape[1]}) f32 buffer "
        f"({buffer_gb:.3f} GB) in {feed_s:.3f} s (host clock, synchronized; "
        f"{feed_s / n_batches * 1e3:.2f} ms a batch, one batch's pageable "
        f"copy {copy_ms:.3f} ms by CUDA events), waveform "
        f"{wave_bytes / feed_s / 1e9:.2f} GB/s host to card; the first "
        f"batch's {first} rows bit-equal to the host route's; kmeans_fit "
        f"on the view, vocab {cfg.vocab_size}, {cfg.niter} iterations "
        f"{fit_s:.3f} s = {fit_s / cfg.niter * 1e3:.2f} ms an iteration, B2 "
        f"{launches} launches, objective {obj:.6f}; peak device memory "
        f"{peak_gb:.3f} GB above the {base_gb:.3f} GB held before (the "
        f"feed alone {feed_peak_gb - base_gb:.3f}; bound {limit_gb:.3f} = "
        f"buffer + phase 8's fit overhead + 1)")
    records[1]["launches_by_path"]["fused_feed_fit"] = launches
    sums_record(records)["launches_by_path"]["fused_feed_fit"] = \
        tier_sums64.launches
    records[1]["fused_feed_10k"] = dict(
        clips=FEED_CLIPS, rows=offset, capacity=buffer.shape[0],
        buffer_gb=buffer_gb, feed_s=feed_s, batch_copy_ms=copy_ms,
        wave_gb_per_s=wave_bytes / feed_s / 1e9, fit_s=fit_s,
        iteration_ms=fit_s / cfg.niter * 1e3, peak_gb=peak_gb,
        feed_peak_gb=feed_peak_gb - base_gb, peak_limit_gb=limit_gb)
    del buffer, manifest, centroids
    torch.cuda.empty_cache()


def train_bound(cfg, n_params: int):
    """(bound_ms, bound_by, flop) of one training step of a family at batch
    B_LSTM: ``tools/bench_training.py``'s FLOPs over the card's peak for
    the compute type (the simple family: its head GEMM), against the bytes
    AdamW moves (f32 parameter, gradient and two moments read, three
    written: 28 bytes a parameter) plus, for the simple family, the
    embedding gather's (B, T, E) f32 rows read in the forward and written
    in the backward."""
    b, t = B_LSTM, cfg.max_seq_len
    nbytes = 28 * n_params
    if cfg.model_type == "simple":
        flop = 3.0 * 2 * b * cfg.hidden_size * cfg.num_classes
        nbytes += 2 * b * t * cfg.hidden_size * 4
    elif cfg.model_type == "cnn":
        m = cfg.n_mels
        flop = 3.0 * b * (2.0 * t * m * 9 * 32
                          + 2.0 * (t // 2) * (m // 2) * 9 * 32 * 64
                          + 2.0 * ((t // 4) * (m // 4) * 64 * 256
                                   + 256 * cfg.num_classes))
    else:
        d = t * cfg.n_mels
        flop = 3.0 * 2.0 * b * (d * 512 + 512 * 256 + 256 * cfg.num_classes)
    dtype = "float32" if cfg.model_type == "simple" else cfg.compute_dtype
    return (*bound_of(flop, nbytes, dtype), flop)


def serve_ckpt(records, tag: str, cfg, dev, clips, kernels, must):
    """``ServingProgram(cfg, "no-wandb-best", device=dev)`` answers one
    batch of 64 clips and one single clip, the launch counters of
    ``kernels`` (B1, B2, B3, B5 forward) reset just before and read just
    after (``launches_by_path`` ``serve_ckpt_<tag>``; the kernels at the
    indices ``must`` must move, bert's B5 counting for the bf16 record).
    The tokens must equal ``FusedTokenizer``'s; the first two clips' probs
    through the program at f32 on the card and on the CPU within
    PROBS_ATOL.  Returns the program."""
    import torch

    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    prog = ServingProgram(cfg, "no-wandb-best", device=dev)
    batch, lengths = prog.tokenizer.frontend.prepare_batch(clips)
    x, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    tokens, n_valid, probs = prog(x, ln)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    one_tokens, one_probs = prog.predict_waveforms(clips[:1])
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = [k.launches for k in kernels]
    check_served(tokens, n_valid, probs, len(clips),
                 prog.tokenizer.frontend.frames_max, cfg.num_classes)
    if one_probs.shape != (1, cfg.num_classes):
        raise AssertionError(f"{tag}: single clip answered wrongly")
    ref = FusedTokenizer.from_artifacts(cfg, dev).tokens_from_padded(
        x.to(dev))
    if not torch.equal(tokens, ref):
        raise AssertionError(f"{tag}: tokens differ from FusedTokenizer's")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    two = [ServingProgram(f32, "no-wandb-best", device=d)(x[:2], ln[:2])
           for d in (dev, "cpu")]
    perr = float((two[0][2].cpu() - two[1][2]).abs().max())
    frac, gap = check_near_ties(
        l2_normalize(prog.tokenizer.kernel.log_mel_plain(x[:2].to(dev))),
        prog.tokenizer.centroids.cpu(), tokens[:2].cpu(), two[1][0])
    dtype = (cfg.compute_dtype if cfg.model_type in ("bert", "cnn",
                                                      "baseline")
             else "float32")
    log(f"[serve ckpt {tag}] ServingProgram(config) from "
        f"{Path(cfg.checkpoint_dir).name}/no-wandb-best, {dtype}"
        f": batch of {len(clips)} {batch_ms:.1f} ms (host clock, first "
        f"call, host->card copy included), single clip {single_ms:.1f} ms; "
        f"launches B1, B2, B3, B5 {launches}; tokens equal FusedTokenizer's"
        f"; 2 clips at f32 card vs CPU: probs max abs err {perr:.3e} (atol "
        f"{PROBS_ATOL}), tokens {frac:.2e} disagree (gap {gap:.3e})")
    if not perr <= PROBS_ATOL:
        raise AssertionError(f"{tag}: probs differ from the CPU by "
                             f"{perr:.3e}")
    for i in must:
        if launches[i] < 1:
            raise AssertionError(f"{tag}: a kernel of the path never "
                                 f"launched: {launches}")
    for rec, n in zip((records[0], records[1], records[2], records[4]),
                      launches):
        if n:
            rec["launches_by_path"][f"serve_ckpt_{tag}"] = n
    return prog


def predict_ckpt(tag: str, cfg, dev, ytid: str, prog) -> None:
    """``ManualTester(cfg, device=dev).run(ytid)`` prints the report; its
    ``Predictor``'s probabilities for the clip must equal the serving
    program ``prog``'s (``predict_waveforms``) within PREDICT_TOL, the rows
    be ranked and ``is_true`` agree with the metadata."""
    import torch

    from audio_tokens_tpu_torch.data.audio_io import decode_audio
    from audio_tokens_tpu_torch.data.metadata import (
        AudiosetMetadataProcessor)
    from audio_tokens_tpu_torch.infer import ManualTester

    t0 = time.perf_counter()
    tester = ManualTester(cfg, device=dev)
    rows = tester.run(ytid, top_k=5)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    path = tester.find_audio_file(ytid)
    t0 = time.perf_counter()
    tokens, probs = tester.predictor.predict_file(path)
    predict_ms = (time.perf_counter() - t0) * 1e3
    wave, _ = decode_audio(path, target_sr=cfg.common_sr)
    p_tokens, p_probs = prog.predict_waveforms([wave])
    err = float(np.abs(probs - p_probs[0]).max())
    truth = set(AudiosetMetadataProcessor(cfg).get_ytid_labels(ytid))
    scores = [r["score"] for r in rows]
    log(f"[predict {tag}] ManualTester.run({ytid}) {report_s:.2f} s (the "
        f"Predictor and metadata built); Predictor.predict_file "
        f"{predict_ms:.1f} ms; probs vs ServingProgram.predict_waveforms "
        f"max abs err {err:.3e} (rtol {PREDICT_TOL['rtol']}, atol "
        f"{PREDICT_TOL['atol']}); {len(tokens)} tokens; true labels "
        f"{sorted(truth)}, top 5 {[r['class_index'] for r in rows]}")
    if not np.allclose(probs, p_probs[0], **PREDICT_TOL):
        raise AssertionError(f"{tag}: Predictor and ServingProgram differ "
                             f"by {err:.3e}")
    if not np.array_equal(tokens, p_tokens[0]):
        raise AssertionError(f"{tag}: Predictor's tokens differ")
    if scores != sorted(scores, reverse=True) or [
            r["rank"] for r in rows] != [1, 2, 3, 4, 5]:
        raise AssertionError(f"{tag}: rows not ranked: {rows}")
    if any(r["is_true"] != (r["class_index"] in truth) for r in rows):
        raise AssertionError(f"{tag}: is_true disagrees with the metadata")


def families_phase(records: list, dev, base: Path, cfg,
                   bert_ckpt: Path) -> None:
    """Phase 10 on phase 8's workspace: train the simple, cnn and baseline
    families through ``ModelTrainer(cfg, dev).run()``, hold their trained
    weights' gradients to the CPU's, then serve every family from its
    checkpoint (the lstm from phase 8's, bert from phase 7's) through
    ``ServingProgram(config)``, ``Predictor`` and ``ManualTester``."""
    import torch

    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd
    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence_fwd
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer

    t_phase = time.perf_counter()
    configs = {}
    for tag, fam in FAMILIES.items():
        fcfg = dataclasses.replace(
            cfg, **fam, checkpoint_dir=str(base / f"checkpoints_{tag}"),
            num_workers=2, log_every_steps=0, device_corpus="off")
        configs[tag] = fcfg
        trainer = ModelTrainer(fcfg, dev)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        (val_loss, val_metrics, step_ms, run_s, peak_gb,
         _) = timed_run(trainer, ())
        b_ms, b_by, flop = train_bound(fcfg, n_params)
        med = statistics.median(step_ms[1:])
        STREAM_STEP_MS[tag] = med
        dtype = "float32" if tag == "simple" else fcfg.compute_dtype
        log(f"[train {tag}] {fam}, {fcfg.num_classes} classes, T "
            f"{fcfg.max_seq_len}, batch {B_LSTM}, {dtype}: {n_params} "
            f"parameters ({n_params / 1e6:.1f}M); {len(step_ms)} steps, ms "
            f"per step {', '.join(f'{t:.1f}' for t in step_ms)} (host clock, "
            f"synchronized; median of steps 2..{len(step_ms)} {med:.2f} ms); "
            f"bound {b_ms:.3f} ms ({b_by}: {flop / 1e9:.1f} GFLOP {dtype}, "
            f"AdamW {28 * n_params / 1e9:.3f} GB); run() {run_s:.1f} s incl. "
            f"corpus load, validation and checkpoint; val loss "
            f"{val_loss:.6f}, val mAP {val_metrics['mAP']:.6f}; peak device "
            f"memory {peak_gb:.2f} GiB")
        if len(step_ms) != TRAIN_STEPS:
            raise AssertionError(f"{tag} trained {len(step_ms)} steps")
        if not (np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0
                and (Path(fcfg.checkpoint_dir) / "no-wandb-best"
                     / "params.pt").exists()):
            raise AssertionError(f"{tag}: val loss {val_loss}, mAP "
                                 f"{val_metrics}, or no checkpoint")
        # the trained weights on the CPU: f32 (every family), then the
        # trained bf16 model against the CPU's bf16 one
        state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
        rows = first_val_rows(fcfg, 4)
        f32 = dataclasses.replace(fcfg, compute_dtype="float32")
        card32, cpu32 = (get_model(f32, d, torch.Generator().manual_seed(0))
                         for d in (dev, "cpu"))
        for m in (card32, cpu32):
            m.load_state_dict(state)
        ref32 = card_vs_cpu_grads(f"[train {tag} reference] f32:", card32,
                                  cpu32, *rows, train=True)
        if tag != "simple":
            cpu16 = get_model(fcfg, "cpu", torch.Generator().manual_seed(0))
            cpu16.load_state_dict(state)
            card_vs_cpu_grads(f"[train {tag} reference] bf16:",
                              trainer.model, cpu16, *rows, train=True,
                              f32_ref=ref32)
            del cpu16
        del trainer, card32, cpu32, state
        torch.cuda.empty_cache()

    clips = make_clips(BATCH, 3 * BATCH)
    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd,
               flash_attention_fwd)
    configs["lstm"] = cfg
    configs["bert"] = dataclasses.replace(
        cfg, **BERT, checkpoint_dir=str(bert_ckpt))
    must = {"lstm": (0, 2), "bert": (0, 3)}
    ytid = json.loads(Path(cfg.split_file).read_text())["validation"][0]
    for tag, fcfg in configs.items():
        prog = serve_ckpt(records, tag, fcfg, dev, clips, kernels,
                          must.get(tag, (0,)))
        predict_ckpt(tag, fcfg, dev, ytid, prog)
        del prog
        torch.cuda.empty_cache()
    log(f"[families] phase 10 took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")


def median_ms(fn, n: int = 3) -> float:
    """Median host-clock ms of ``n`` synchronized calls of ``fn``."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def opcheck_phase(dev) -> None:
    """``torch.library.opcheck`` of the eight custom ops on small card
    tensors (schema, fake, autograd registration, dynamic-shape dispatch):
    the four forward ops, B3 and B5's forward also with inputs that require
    a gradient (their registered backward: B4's ops, B5's pair), and the
    four backward ops (B4's with carries); B5's forward with a gradient and
    its pair also on a query block (``kv_segment_ids``: 20 query rows
    against 37 keys); its launches fall outside every counted path."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_plain)
    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence_fwd_plain
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend

    gen = torch.Generator().manual_seed(21)
    fe = MelFrontend("cpu", SR, 64, 512, 128, SR)
    kern = TokenizerKernel(SR, 64, 512, 128, fe.frames_max,
                           make_centroids(40, 21), dev)
    padded = torch.from_numpy(fe.prepare_batch(make_clips(3, 7))[0]).to(dev)
    xg = torch.randn((20, 3, 64), generator=gen).to(dev)
    mask = (torch.arange(20)[:, None] < torch.tensor([20, 9, 0])).float()
    w_hh = (torch.randn((16, 64), generator=gen) / 4).to(dev)
    q, k, v = (torch.randn((2, 2, 37, HEAD_DIM), generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    seg = (torch.arange(37)[None, :] >= torch.tensor([[37], [20]])).to(
        dev, torch.int32)
    mask = mask.to(dev)
    h0, c0, dc_last, dh_last = (torch.randn((3, 16), generator=gen).to(dev)
                                for _ in range(4))
    hs, gates, c, _ = lstm_sequence_fwd_plain(xg, mask, w_hh, True, h0, c0)
    dhs = torch.randn(hs.shape, generator=gen).to(dev)
    dxg = torch.randn(gates.shape, generator=gen).to(dev)
    o, lse = flash_attention_plain(q, k, v, seg, SM_SCALE, True)
    do = torch.randn(q.shape, generator=gen).to(dev, torch.bfloat16)
    di = (o.float() * do.float()).sum(-1)
    leaves = [t.clone().requires_grad_() for t in (xg, w_hh, h0, c0)]
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    qb, dob = (t[:, :, 17:].contiguous() for t in (q, do))
    seg_q = seg[:, 17:].contiguous()
    ob, lseb = flash_attention_plain(qb, k, v, seg_q, SM_SCALE, True,
                                     kv_segment_ids=seg)
    block = (qb, k, v, seg_q, lseb, dob, (ob.float() * dob.float()).sum(-1),
             SM_SCALE, seg)
    cases = {
        "atk::vq_argmin": (torch.ops.atk.vq_argmin.default, (
            torch.randn((300, 64), generator=gen).to(dev),
            torch.randn((40, 64), generator=gen).to(dev), True)),
        "atk::tokenize": (torch.ops.atk.tokenize.default, (
            padded, kern._kbasis, kern._kfbank, kern.centroids, kern.c2,
            kern.n_fft, kern.hop, kern.padded_len, kern.n_frames)),
        "atk::lstm_fwd": (torch.ops.atk.lstm_fwd.default, (
            xg, mask, w_hh, True, True)),
        "atk::flash_fwd": (torch.ops.atk.flash_fwd.default, (
            q, k, v, seg, SM_SCALE, True)),
        "atk::lstm_fwd (carries, autograd)": (
            torch.ops.atk.lstm_fwd.default, (
                leaves[0], mask, leaves[1], True, True, *leaves[2:])),
        "atk::flash_fwd (autograd)": (torch.ops.atk.flash_fwd.default, (
            *qkv, seg, SM_SCALE, True)),
        "atk::lstm_bwd": (torch.ops.atk.lstm_bwd.default, (
            dhs, dh_last, gates, c, mask, w_hh, True, dc_last, c0)),
        "atk::lstm_dw": (torch.ops.atk.lstm_dw.default, (hs, dxg, True, h0)),
        "atk::flash_bwd_dkv": (torch.ops.atk.flash_bwd_dkv.default, (
            q, k, v, seg, lse, do, di, SM_SCALE)),
        "atk::flash_bwd_dq": (torch.ops.atk.flash_bwd_dq.default, (
            q, k, v, seg, lse, do, di, SM_SCALE)),
        "atk::flash_fwd (query block, autograd)": (
            torch.ops.atk.flash_fwd.default, (
                qkv[0][:, :, 17:].detach().clone().requires_grad_(),
                *qkv[1:], seg_q, SM_SCALE, True, seg)),
        "atk::flash_bwd_dkv (query block)": (
            torch.ops.atk.flash_bwd_dkv.default, block),
        "atk::flash_bwd_dq (query block)": (
            torch.ops.atk.flash_bwd_dq.default, block),
    }
    for name, (op, args) in cases.items():
        report = torch.library.opcheck(op, args)
        torch.cuda.synchronize()
        log(f"[opcheck] {name} on {dev}: {report}")
        if set(report.values()) != {"SUCCESS"}:
            raise AssertionError(f"{name} failed opcheck: {report}")


def export_phase(records: list, dev, base: Path, cfg,
                 bert_ckpt: Path) -> dict:
    """Phase 11: export the lstm and bert serving programs in kernel form
    on the card and hold the loaded programs to the live ones; export the
    lstm portable on the CPU and run it on the card; opcheck the ops; run
    ``tools/serve_bench`` in-process."""
    import torch

    from audio_tokens_tpu_torch.export import (PROGRAM_NAME, ServingProgram,
                                               export_serving, load_serving)
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd
    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence_fwd
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
    from audio_tokens_tpu_torch.tools import serve_bench

    t_phase = time.perf_counter()
    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd,
               flash_attention_fwd)
    names = ("B1", "B2", "B3", "B5")

    def counted(fn):
        torch.cuda.synchronize()
        for kern in kernels:
            kern.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [kern.launches for kern in kernels]

    clips = make_clips(BATCH, 4 * BATCH)
    bcfg = dataclasses.replace(cfg, **BERT, checkpoint_dir=str(bert_ckpt))
    cases = (("lstm", cfg, ["atk::lstm_fwd", "atk::tokenize"], (0, 2)),
             ("bert", bcfg, ["atk::flash_fwd", "atk::tokenize"], (0, 3)))
    kernel_out = None
    for tag, fcfg, ops, must in cases:
        out_dir = base / f"serving_{tag}"
        t0 = time.perf_counter()
        export_serving(fcfg, out_dir, BATCH, portable=False, device=dev)
        export_s = time.perf_counter() - t0
        nbytes = (out_dir / PROGRAM_NAME).stat().st_size
        t0 = time.perf_counter()
        module, manifest = load_serving(out_dir, device=dev)
        load_s = time.perf_counter() - t0
        if manifest["custom_ops"] != ops or manifest["platforms"] != [dev.type]:
            raise AssertionError(f"{tag}: manifest ops "
                                 f"{manifest['custom_ops']}, platforms "
                                 f"{manifest['platforms']}")
        live = ServingProgram(fcfg, device=dev)
        batch, lengths = live.tokenizer.frontend.prepare_batch(clips)
        x = torch.from_numpy(batch).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        with torch.inference_mode():
            got, launches = counted(lambda: module(x, ln))
            ref = live(x, ln)
            loaded_ms = median_ms(lambda: module(x, ln))
            live_ms = median_ms(lambda: live(x, ln))
        check_served(*got, BATCH, live.tokenizer.frontend.frames_max,
                     fcfg.num_classes)
        perr = float((got[2] - ref[2]).abs().max())
        log(f"[export {tag}] kernel form ({', '.join(ops)}), batch {BATCH}: "
            f"export {export_s:.2f} s, {nbytes} bytes, load {load_s:.2f} s; "
            f"a batch of {BATCH} (inputs on the card, host clock, "
            f"synchronized, median of 3): loaded {loaded_ms:.1f} ms, live "
            f"{live_ms:.1f} ms; launches {dict(zip(names, launches))}; "
            f"tokens and n_valid equal the live program's: "
            f"{torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])}"
            f"; probs max abs err {perr:.3e} (atol {EXPORT_PROBS_ATOL})")
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{tag}: the loaded program's tokens differ")
        if not perr <= EXPORT_PROBS_ATOL:
            raise AssertionError(f"{tag}: probs differ by {perr:.3e}")
        for i in must:
            if launches[i] < 1:
                raise AssertionError(f"{tag}: the loaded program launched "
                                     f"no {names[i]}: {launches}")
        for rec, n in zip((records[0], records[1], records[2], records[4]),
                          launches):
            if n:
                rec["launches_by_path"][f"export_{tag}"] = n
        if tag == "lstm":
            kernel_out = [t[:PORTABLE_CLIPS].cpu() for t in got]
            x8, ln8 = x[:PORTABLE_CLIPS], ln[:PORTABLE_CLIPS]
            unit8 = l2_normalize(live.tokenizer.kernel.log_mel_plain(x8))
            cents = live.tokenizer.centroids
        del module, live, got, ref
        torch.cuda.empty_cache()

    # the portable lstm: exported on the CPU, run on the card
    out_dir = base / "serving_lstm_portable"
    t0 = time.perf_counter()
    export_serving(cfg, out_dir, PORTABLE_CLIPS, portable=True, device="cpu")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    module, manifest = load_serving(out_dir, device=dev)
    load_s = time.perf_counter() - t0
    if manifest["custom_ops"] or manifest["platforms"] != ["cpu", "cuda"]:
        raise AssertionError(f"portable manifest: {manifest['custom_ops']}, "
                             f"{manifest['platforms']}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        got, launches = counted(lambda: module(x8, ln8))
    run_ms = (time.perf_counter() - t0) * 1e3
    got = [t.cpu() for t in got]
    frac, gap = check_near_ties(unit8, cents, got[0], kernel_out[0])
    perr = float((got[2] - kernel_out[2]).abs().max())
    log(f"[export lstm portable] exported on the CPU ({export_s:.2f} s, "
        f"{(out_dir / PROGRAM_NAME).stat().st_size} bytes), loaded onto "
        f"{dev} ({load_s:.2f} s): {PORTABLE_CLIPS} clips in {run_ms:.0f} ms "
        f"(first call, synchronized); launches {dict(zip(names, launches))}"
        f"; vs the kernel program: tokens {frac:.2e} disagree (gap "
        f"{gap:.3e}), n_valid equal {torch.equal(got[1], kernel_out[1])}, "
        f"probs max abs err {perr:.3e} (atol {PROBS_ATOL})")
    if any(launches):
        raise AssertionError(f"the portable program launched {launches}")
    if not torch.equal(got[1], kernel_out[1]) or not perr <= PROBS_ATOL:
        raise AssertionError(f"portable lstm: n_valid or probs ({perr:.3e}) "
                             "differ from the kernel program's")
    del module, x8, ln8, unit8
    torch.cuda.empty_cache()

    opcheck_phase(dev)

    bench = {
        "tokens": [],
        "lstm": ["--classify", "lstm"],
        "bert": ["--classify", "bert", "--transformer_max_position", "1728",
                 "--transformer_attention", "flash"],
    }
    must = {"tokens": (0,), "lstm": (0, 2), "bert": (0, 3)}
    results = {}
    for tag, extra in bench.items():
        argv = ["--n_clips", str(SERVE_BENCH_CLIPS), "--latency",
                str(SERVE_BENCH_LATENCY), "--device", str(dev),
                "--audio_backend", "python", *extra]
        result, launches = counted(lambda: serve_bench.main(argv))
        results[tag] = result
        log(f"[serve_bench {tag}] {' '.join(argv)}: {result['clips_per_s']:.1f}"
            f" clips/s over {result['n_clips']} clips ({result['seconds']:.2f}"
            f" s); a batch of {result['batch']}: decode {result['decode_ms']:.1f} ms "
            f"(in the loop, median {result['decode_loop_ms']:.1f}), "
            f"transfer + card {result['device_ms']:.1f} ms; one request p50 "
            f"{result['p50_ms']:.1f} / p90 {result['p90_ms']:.1f} / p99 "
            f"{result['p99_ms']:.1f} / max {result['max_ms']:.1f} ms over "
            f"{SERVE_BENCH_LATENCY} requests (decode p50 "
            f"{result['decode_p50_ms']:.1f}); launches "
            f"{dict(zip(names, launches))}")
        for i in must[tag]:
            if launches[i] < 1:
                raise AssertionError(f"serve_bench {tag} launched no "
                                     f"{names[i]}: {launches}")
        for rec, n in zip((records[0], records[1], records[2], records[4]),
                          launches):
            if n:
                rec["launches_by_path"][f"serve_bench_{tag}"] = n
    log(f"[export] phase 11 took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")
    return results


SUMS_NAME = "K-means centroid sums (sorted rows, f64 runs, every tier)"


def sums_record(records: list) -> dict:
    """The centroid sums kernel's record (made by phase 8)."""
    return next(r for r in records if r["name"] == SUMS_NAME)


def sums_split(x, ids, k: int) -> dict:
    """The parts of ``tier_sums64`` at these rows, each timed alone with
    CUDA events: the stable sort, the clusters' bounds (searchsorted); the
    kernel's two passes are the rest."""
    import torch

    sid, _ = torch.sort(ids, stable=True)
    keys = torch.arange(k + 1, dtype=sid.dtype, device=x.device)
    out = dict(sort_ms=cuda_ms(lambda: torch.sort(ids, stable=True), 3),
               bounds_ms=cuda_ms(lambda: torch.searchsorted(sid, keys), 3))
    del sid
    return out


def sums_check(x, ids, k: int, tier: str) -> tuple:
    """``tier_sums64`` on the card against its plain version on the same
    tensors: (largest f64 error, largest f64 error over the entry's sum of
    |parts|, share of the f32 roundings apart, their largest ulp gap);
    raises past 1e-12 of the sum of |parts|, 1e-4 and 1 ulp."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_kmeans import (tier_sums64,
                                                        tier_sums64_plain)
    from audio_tokens_tpu_torch.ops.tiers import tier_operands

    got = tier_sums64(x, ids, k, tier)
    ref = tier_sums64_plain(x, ids, k, tier)
    mags = torch.stack([tier_sums64_plain(p.abs(), ids, k)[0]
                        for p in tier_operands(x, tier)])
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / mags.clamp_min(1e-300)).max())
    g32, r32 = got.float(), ref.float()
    apart = g32 != r32
    frac = float(apart.float().mean())
    ulps = int((g32.view(torch.int32).long() - r32.view(torch.int32).long())
               .abs().max())
    if not (rel <= 1e-12 and frac <= 1e-4 and ulps <= 1):
        raise AssertionError(f"sums at {tier}: {rel:.3e} of sum|x| from the "
                             f"plain version, {frac:.2e} of the f32 sums "
                             f"apart, {ulps} ulp at most")
    return err, rel, frac, ulps


class IterationLog(logging.Handler):
    """Collects the streaming fit's per-iteration log lines: (seconds,
    seconds waiting on the stream)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.iters = []

    def emit(self, record):
        if record.msg.startswith("streaming kmeans iter"):
            self.iters.append((record.args[4], record.args[5]))


def stream_phase(records: list, cfg, dev, x, ref) -> None:
    """The 17.23M rows streamed back from the host through
    ``kmeans_fit_streaming`` from the in-memory fit's init, in four modes;
    the three f32 modes must be bit-equal and agree with the in-memory fit
    ``ref`` within CENT_ATOL, ids differing at near-ties only; bf16 is held
    to the in-memory fit of the bf16-rounded rows."""
    import torch

    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.ops.vq import check_near_ties

    n, d = x.shape
    k = cfg.vocab_size
    init = x[torch.from_numpy(np.random.default_rng(cfg.random_seed).choice(
        n, size=k, replace=False)).to(dev)]
    t0 = time.perf_counter()
    host = x.cpu().numpy()
    to_host_s = time.perf_counter() - t0
    piece = STREAM_PIECE_CLIPS * (1 + cfg.clip_samples // cfg.hop_length)

    def stream():
        return (host[i : i + piece] for i in range(0, n, piece))

    capacity = max(1, cfg.kmeans_superbatch_rows // km.DEFAULT_CHUNK) * \
        km.DEFAULT_CHUNK
    n_sb = -(-n // capacity)
    pinned = torch.empty((capacity, d), pin_memory=True)
    on_card = torch.empty((capacity, d), device=dev)
    link_ms = cuda_ms(lambda: on_card.copy_(pinned, non_blocking=True), 5)
    link_gbs = pinned.numel() * 4 / link_ms / 1e6
    del pinned, on_card
    handler = IterationLog()
    klog = logging.getLogger("audio_tokens_tpu_torch.ops.kmeans")
    klog.addHandler(handler)
    klog.setLevel(logging.INFO)
    modes = [("restream", {}, torch.float32),
             ("host_cache", {"cache_mb": 8192}, torch.float32),
             ("hbm_cache", {"hbm_cache_mb": cfg.kmeans_hbm_cache_mb},
              torch.float32),
             ("bf16_hbm_cache", {"hbm_cache_mb": cfg.kmeans_hbm_cache_mb},
              torch.bfloat16)]
    out, fits = {}, {}
    try:
        for name, caches, wire in modes:
            handler.iters = []
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            before = vq_argmin.launches
            tier_sums64.launches = 0
            t0 = time.perf_counter()
            c, obj, seen = km.kmeans_fit_streaming(
                stream, k, cfg.niter, d=d, seed=cfg.random_seed,
                init_centroids=init, wire_dtype=wire, device=dev,
                superbatch_rows=cfg.kmeans_superbatch_rows, **caches)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = vq_argmin.launches - before
            if launches != n_sb * cfg.niter or seen != n or \
                    tier_sums64.launches != launches:
                raise AssertionError(f"{name}: B2 launched {launches} times "
                                     f"and the sums {tier_sums64.launches} "
                                     f"over {seen} rows")
            copying = handler.iters[:1] if "hbm_cache_mb" in caches \
                else handler.iters
            wire_bytes = n * d * (4 if wire == torch.float32 else 2)
            iter_s = [s for s, _ in handler.iters]
            out[name] = dict(
                fit_s=fit_s, iteration_ms=fit_s / cfg.niter * 1e3,
                first_iteration_ms=iter_s[0] * 1e3,
                later_iteration_ms=statistics.mean(iter_s[1:]) * 1e3,
                wait_s=sum(w for _, w in handler.iters),
                h2d_gb_per_s=wire_bytes * len(copying)
                / sum(s for s, _ in copying) / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                base_gb=base_gb, launches=launches, objective=obj)
            fits[name] = c
    finally:
        klog.removeHandler(handler)
    del host
    f32 = fits["restream"]
    for name in ("host_cache", "hbm_cache"):
        if not (torch.equal(fits[name], f32) and out[name]["objective"]
                == out["restream"]["objective"]):
            raise AssertionError(f"{name} replay differs from re-streaming")
    err = float((f32 - ref).abs().max())
    frac, gap = check_near_ties(x, ref, km.assign(x, f32), km.assign(x, ref))
    x_bf = x.bfloat16().float()
    ref_bf, _ = km.kmeans_fit(x_bf, k, cfg.niter, init_centroids=init)
    bf_err = float((fits["bf16_hbm_cache"] - ref_bf).abs().max())
    bf_vs_f32 = float((fits["bf16_hbm_cache"] - f32).abs().max())
    del x_bf
    if not (err <= CENT_ATOL and bf_err <= CENT_ATOL):
        raise AssertionError(f"streaming fits differ from the in-memory fits "
                             f"by {err:.3e} (f32) and {bf_err:.3e} (bf16)")
    for name, m in out.items():
        log(f"[kmeans stream] {name}: {n} rows in {n_sb} super-batches of "
            f"{capacity}, {cfg.niter} iterations {m['fit_s']:.3f} s = "
            f"{m['iteration_ms']:.2f} ms an iteration (first "
            f"{m['first_iteration_ms']:.2f}, later "
            f"{m['later_iteration_ms']:.2f}; host clock, synchronized); "
            f"waiting on the stream {m['wait_s']:.3f} s; host to card "
            f"{m['h2d_gb_per_s']:.2f} GB/s over the iterations that copy; "
            f"peak device memory {m['peak_gb']:.3f} GB ({m['base_gb']:.3f} GB "
            f"held before the fit); B2 launches {m['launches']}; objective "
            f"{m['objective']:.6f}")
    log(f"[kmeans stream] rows to the host in {to_host_s:.2f} s; one pinned "
        f"{capacity}-row copy to the card {link_ms:.3f} ms = {link_gbs:.2f} "
        f"GB/s (CUDA events); restream, host_cache and hbm_cache bit-equal; "
        f"f32 vs the in-memory fit max abs err {err:.3e} (atol {CENT_ATOL}), "
        f"ids {frac:.2e} disagree (gap {gap:.3e}); bf16 vs the in-memory fit "
        f"of the bf16-rounded rows {bf_err:.3e}, vs the f32 fit {bf_vs_f32:.3e}")
    records[1]["kmeans_stream_17M"] = dict(
        rows=n, superbatches=n_sb, capacity=capacity, link_gb_per_s=link_gbs,
        max_abs_err_vs_in_memory=err, bf16_max_abs_err_vs_bf16_in_memory=bf_err,
        modes=out)
    records[1]["launches_by_path"]["kmeans_stream"] = sum(
        m["launches"] for m in out.values())
    sums_record(records)["launches_by_path"]["kmeans_stream"] = sum(
        m["launches"] for m in out.values())


# phase 12: the precision tiers' peak rates: bf16 on the tensor cores, and
# bf16x3's three passes for one product
TIER_FLOPS = {"highest": PEAK_FLOPS["float32"], "bf16x3": PEAK_FLOPS[
    "bfloat16"] / 3, "default": PEAK_FLOPS["bfloat16"]}
KMEANS_TIERS = (("high", "bf16x3"), ("default", "default"))
# (n_fft, hop, n_mels) the bf16 front end took up in PR 17 (C5): a hop off
# 16 and off 8 at n_fft 400, 256 mel bands
C5_SHAPES = ((400, 200, 64), (400, 100, 64), (512, 128, 256))
# the K-means objective's drift from the highest fit that a tier's fit may
# show: the card's readings are 1.5e-8 (high) and 7.4e-6 (default) at
# 17.23M x 64 x 500; the JAX package documents ~4e-5 for default on a TPU
KMEANS_DRIFT = {"high": 1e-6, "default": 1e-4}


def fmt_share(share) -> str:
    """A share from ``check_follows_tier``, or why there is none."""
    return "too few rows" if share is None else f"{share:.4f}"


def tier_bound(ops: dict, nbytes: float):
    """(ms, "bytes" or "operations"): ``ops`` maps a tier to the operations
    done at it, each over that tier's peak, against ``nbytes`` over the
    memory rate."""
    ops_ms = sum(n / TIER_FLOPS[t] for t, n in ops.items()) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def coarse_tier(*tiers) -> str:
    """The coarsest of the tiers: the near-tie bound two results of them
    are held to."""
    for t in ("default", "bf16x3"):
        if t in tiers:
            return t
    return "highest"


def host_cpu(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The host CPU as /proc/cpuinfo names it: its ``model name`` with the
    vendor, family and model numbers beside it (a virtual machine may
    report the name as ``unknown``)."""
    fields = {}
    try:
        for line in Path(cpuinfo).read_text().splitlines():
            if not line.strip():
                break  # the first processor's block
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name, vendor = fields.get("model name", "unknown"), fields.get(
        "vendor_id", "?")
    return (f"{name} ({vendor}, family {fields.get('cpu family', '?')}, "
            f"model {fields.get('model', '?')})")


def tiers_mirror(cfg, clips, cents, exact0, b1_ms: float) -> None:
    """``[mirror]``: the reference pipeline's torch-CPU mirror
    (``tools/bench_tokenizer_tiers.mirror_row``: 16 threads, best of 3 on
    MIRROR_CLIPS clips) at ``cents``, beside B1 at ``highest`` (``b1_ms`` a
    batch of BATCH); its tokens held to B1's (``exact0``, clip 0) at
    MIRROR_AGREE or more, on B1's signal chain (``cfg``).  The thread
    count is restored."""
    import torch

    from audio_tokens_tpu_torch.tools.bench_tokenizer_tiers import (
        HOP, N_FFT, N_MELS, SR as BENCH_SR, mirror_row)

    if (BENCH_SR, N_MELS, N_FFT, HOP) != (cfg.common_sr, cfg.n_mels,
                                          cfg.n_fft, cfg.hop_length):
        raise AssertionError("the mirror's signal chain is not B1's")
    threads = torch.get_num_threads()
    row = mirror_row(clips[:MIRROR_CLIPS], cents, exact0)
    if torch.get_num_threads() != threads:
        raise AssertionError("the mirror left torch's thread count changed")
    b1_cps = BATCH / b1_ms * 1e3
    log(f"[mirror] reference pipeline's torch-CPU mirror (torch.stft, mel, "
        f"cdist argmin) at K {len(cents)}: {row['clips_per_s']:.2f} clips/s "
        f"({row['ms']:.1f} ms a clip, best of 3 on {MIRROR_CLIPS} clips) on "
        f"{host_cpu()}, {row['threads']} threads ({os.cpu_count()} cores "
        f"seen); B1 at highest {b1_cps:.1f} clips/s ({b1_ms:.3f} ms a batch "
        f"of {BATCH}) on {card_line()}: {b1_cps / row['clips_per_s']:.1f}x; "
        f"the mirror's tokens of clip 0 agree with B1's at highest on "
        f"{row['agreement'] * 100:.2f}% of frames (bound "
        f"{MIRROR_AGREE * 100:.0f}%), frames apart "
        f"{row['frames_apart'][:20]}")
    if not row["agreement"] >= MIRROR_AGREE:
        raise AssertionError(f"the mirror agrees with B1 at highest on "
                             f"{row['agreement']:.4f} of clip 0's frames, "
                             f"frames apart {row['frames_apart']}")


def tiers_b1(records: list, dev) -> None:
    """B1 at each combo of ``tools/bench_tokenizer_tiers`` at K 500 and
    16,384 on 64 ten-second clips, driven through ``FusedTokenizer`` with
    the config's tiers; each against its plain tier version on the card,
    its agreement with ``highest``; one record per combo other than
    (highest, highest)."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import (TokenizerKernel,
                                                           tier_plan)
    from audio_tokens_tpu_torch.ops.tiers import (check_follows_tier,
                                                  check_tier_ties)
    from audio_tokens_tpu_torch.ops.vq import l2_normalize
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
    from audio_tokens_tpu_torch.tools.bench_tokenizer_tiers import COMBOS

    base_cfg = AudioTokensConfig(clip_seconds=CLIP_SECONDS, **MODEL)
    clips = make_clips(BATCH)
    x = dft_ms = None
    by_combo = {}
    for k in (VOCAB, VOCAB_LARGE):
        cents = make_centroids(k, 7 if k == VOCAB else 8)
        exact = None
        for tier, vq in COMBOS:
            cfg = dataclasses.replace(base_cfg, vocab_size=k,
                                      tokenizer_precision=tier,
                                      tokenizer_vq_precision=vq)
            tok = FusedTokenizer(cfg, cents, dev)
            kern = tok.kernel
            if x is None:
                x = torch.from_numpy(tok.frontend.prepare_batch(clips)[0]
                                     ).to(dev)
                # yardstick: the DFT product alone in bf16 (one cuBLAS
                # GEMM of the frames laid out beforehand)
                frames = x[:, :kern.padded_len].unfold(
                    1, cfg.n_fft, cfg.hop_length)[:, :kern.n_frames].reshape(
                    -1, cfg.n_fft).to(torch.bfloat16).contiguous()
                basis = kern.basis.to(torch.bfloat16)
                dft_ms = cuda_ms(lambda: torch.matmul(frames, basis), 10)
                del frames, basis
            torch.cuda.synchronize()
            TokenizerKernel.launches = 0
            got = tok.tokens_from_padded(x)
            torch.cuda.synchronize()
            launches = TokenizerKernel.launches
            if launches != 1:
                raise AssertionError(f"B1 {tier}/{vq}: {launches} launches")
            if exact is None:  # the all-highest kernel: the baseline
                exact = got
                b1_ms = cuda_ms(lambda: kern(x), 10)
                log(f"[tiers B1 highest/highest K {k}] kernel {b1_ms:.3f} "
                    f"ms")
                if k == VOCAB:
                    tiers_mirror(base_cfg, clips, cents,
                                 exact[0].cpu().numpy(), b1_ms)
                continue
            ref = kern.plain(x)
            coarse = coarse_tier(tier, vq)
            frac, gap, worst = check_tier_ties(
                l2_normalize(kern.log_mel_plain(x)), kern.centroids, got,
                ref, coarse)
            apart, followed = check_follows_tier(got, ref, exact, coarse)
            agree = 1.0 - apart
            ms = cuda_ms(lambda: kern(x), 10)
            plain_ms = cuda_ms(lambda: kern.plain(x), 2)
            n_frames = BATCH * tok.frontend.frames_max
            bins = cfg.n_fft // 2 + 1
            front = n_frames * (2 * cfg.n_fft * 2 * bins
                                + 2 * bins * cfg.n_mels)
            ops = {tier: front}
            ops[vq] = ops.get(vq, 0) + n_frames * 2 * cfg.n_mels * k
            b_ms, b_by = tier_bound(ops, x.numel() * 4 + n_frames * 4
                                    + cents.nbytes)
            log(f"[tiers B1 {tier}/{vq} K {k}] {frac:.2e} of the tokens "
                f"apart from the plain tier version (largest score gap "
                f"{gap:.3e}, {worst:.3f} of its {coarse} bound); agreement "
                f"with highest {agree * 100:.4f}%, the plain tier's answer "
                f"taken where it leaves highest: {fmt_share(followed)}; "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms ({b_by}); the DFT product alone in bf16 "
                f"(torch.matmul) {dft_ms:.3f} ms; launches {launches}")
            records.append(dict(
                name=f"B1 tokenizer at tiers {tier}/{vq}, K {k}",
                route="cuda", source="audio_tokens_tpu_torch/csrc/tokenizer.cu",
                replaces="audio_tokens_tpu/ops/pallas_tokenizer.py:222",
                max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=dft_ms, agreement_highest=agree,
                launches_by_path={f"tiers_b1_{tier}_{vq}_k{k}": launches}))
            by_combo[tier, vq, k] = records[-1]
            del tok, kern, got, ref
        del exact
        torch.cuda.empty_cache()
    # the shapes the mma.sync front end refused (C5): a hop off 16 and
    # off 8 at n_fft 400, 256 mel bands, each combo of one bf16 tier
    for n_fft, hop, n_mels in C5_SHAPES:
        cents = make_centroids(VOCAB, 10, n_mels)
        for tier in ("bf16x3", "default"):
            cfg = dataclasses.replace(
                base_cfg, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
                tokenizer_precision=tier, tokenizer_vq_precision=tier)
            exact = FusedTokenizer(dataclasses.replace(
                cfg, tokenizer_precision="highest",
                tokenizer_vq_precision="highest"), cents, dev)
            tok = FusedTokenizer(cfg, cents, dev)
            kern = tok.kernel
            xs = torch.from_numpy(tok.frontend.prepare_batch(clips)[0]).to(dev)
            highest = exact.tokens_from_padded(xs)
            torch.cuda.synchronize()
            TokenizerKernel.launches = 0
            got = tok.tokens_from_padded(xs)
            torch.cuda.synchronize()
            launches = TokenizerKernel.launches
            if launches != 1:
                raise AssertionError(f"B1 {tier}/{tier} at n_fft {n_fft}, hop "
                                     f"{hop}, {n_mels} mels: {launches} "
                                     f"launches")
            ref = kern.plain(xs)
            frac, gap, worst = check_tier_ties(
                l2_normalize(kern.log_mel_plain(xs)), kern.centroids, got,
                ref, tier)
            apart, followed = check_follows_tier(got, ref, highest, tier,
                                                 min_rows=20, band=False)
            ms = cuda_ms(lambda: kern(xs), 5)
            frames, stages, smem = tier_plan(hop, -(-n_fft // 32) * 32,
                                             n_mels, tier, tier)
            log(f"[tiers B1 {tier}/{tier} n_fft {n_fft} hop {hop} mels "
                f"{n_mels}] ({frames} frames a block, {stages} ring stages, "
                f"{smem} B shared) {frac:.2e} of the tokens apart from the "
                f"plain tier version (largest score gap {gap:.3e}, "
                f"{worst:.3f} of its bound); {apart:.3e} apart from "
                f"highest, the plain tier's answer taken where it leaves "
                f"highest: {fmt_share(followed)}; kernel {ms:.3f} ms; "
                f"launches {launches}")
            by_combo[tier, tier, VOCAB]["launches_by_path"][
                f"tiers_b1_{tier}_{tier}_n{n_fft}_h{hop}_m{n_mels}"] = launches
            del tok, exact, kern, xs, got, ref, highest
        torch.cuda.empty_cache()


def tiers_kmeans(records: list, cfg, dev) -> None:
    """B2 at bf16x3 and default at one default clustering batch's rows
    against its plain tier version, and ``KMeans.train`` at
    ``kmeans_precision`` high and default against the ``highest`` fit:
    objective drift, ids apart, iteration time."""
    import torch

    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.tiers import (check_follows_tier,
                                                  check_tier_ties)

    x = kmeans_rows(cfg, dev)
    n, d = x.shape
    sums_rec = sums_record(records)

    def fit(precision):
        f = km.KMeans(d, cfg.vocab_size, niter=cfg.niter,
                      seed=cfg.random_seed, precision=precision, device=dev)
        torch.cuda.synchronize()
        vq_argmin.launches = tier_sums64.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        f.train(x)
        torch.cuda.synchronize()
        if tier_sums64.launches != cfg.niter:
            raise AssertionError(f"KMeans {precision}: the sums launched "
                                 f"{tier_sums64.launches} times")
        sums_rec["launches_by_path"][f"kmeans_{precision}"] = \
            tier_sums64.launches
        return (f, time.perf_counter() - t0, vq_argmin.launches,
                torch.cuda.max_memory_allocated() / 1e9)

    ref, ref_s, _, ref_gb = fit("highest")
    c = ref.centroids
    ids_ref = km.assign(x, c)
    x_bf = x.to(torch.bfloat16)
    c2 = (c * c).sum(1)[None, :]
    c_bf = c.to(torch.bfloat16)

    def matmul_argmin():  # yardstick: one bf16 cuBLAS GEMM a chunk, argmin
        out = torch.empty(n, dtype=torch.int64, device=dev)
        for i in range(0, n, 1 << 18):
            fc = torch.matmul(x_bf[i:i + (1 << 18)], c_bf.T).float()
            out[i:i + (1 << 18)] = (c2 - 2.0 * fc).argmin(1)
        return out

    lib_ms = cuda_ms(matmul_argmin, 3)
    log(f"[tiers kmeans] highest: KMeans.train {ref_s:.3f} s "
        f"({ref_s / cfg.niter * 1e3:.2f} ms an iteration), objective "
        f"{ref.obj:.6f}, peak {ref_gb:.3f} GB")
    for precision, tier in KMEANS_TIERS:
        f, fit_s, launches, peak_gb = fit(precision)
        if launches != cfg.niter:
            raise AssertionError(f"KMeans {precision}: {launches} launches")
        drift = abs(f.obj - ref.obj) / abs(ref.obj)
        apart = float((km.assign(x, f.centroids, tier) != ids_ref)
                      .float().mean())
        cent_err = float((f.centroids - c).abs().max())
        got = vq_argmin(x, c, False, tier)
        plain = vq_argmin_plain(x, c, False, tier=tier)
        frac, gap, worst = check_tier_ties(x, c, got, plain, tier)
        flip, followed = check_follows_tier(got, plain, ids_ref, tier)
        ms = cuda_ms(lambda: vq_argmin(x, c, False, tier), 5)
        plain_ms = cuda_ms(lambda: vq_argmin_plain(x, c, False, tier=tier), 1)
        flop = 2 * n * cfg.vocab_size * d
        b_ms, b_by = tier_bound({tier: flop},
                                x.numel() * 4 + n * 4 + c.numel() * 4)
        if not (np.isfinite(f.obj) and drift < KMEANS_DRIFT[precision]):
            raise AssertionError(f"KMeans {precision}: objective {f.obj} "
                                 f"against highest {ref.obj} (drift limit "
                                 f"{KMEANS_DRIFT[precision]})")
        log(f"[tiers kmeans] {precision} ({tier}): KMeans.train "
            f"{fit_s:.3f} s ({fit_s / cfg.niter * 1e3:.2f} ms an iteration, "
            f"highest {ref_s / cfg.niter * 1e3:.2f}; below highest: "
            f"{fit_s < ref_s}; the sums at the tier "
            f"{sums_rec['by_tier'][tier]['ms']:.3f} ms, phase 8), objective "
            f"{f.obj:.6f}, "
            f"drift from highest {drift:.3e}, centroids max abs diff "
            f"{cent_err:.3e}, ids apart from the highest fit's {apart:.3e}; "
            f"peak {peak_gb:.3f} GB; launches {launches}")
        log(f"[tiers B2 {tier}] {n} x {d} x {cfg.vocab_size}: {frac:.2e} of "
            f"the ids apart from the plain tier version (largest gap "
            f"{gap:.3e}, {worst:.3f} of its bound), {flip:.3e} apart from "
            f"highest, the plain tier's answer taken where it leaves "
            f"highest: {fmt_share(followed)}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}); torch.matmul + argmin in bf16 "
            f"{lib_ms:.3f} ms")
        records.append(dict(
            name=f"B2 vq at tier {tier}, {n} x {d} x {cfg.vocab_size}",
            route="cuda", source="audio_tokens_tpu_torch/csrc/vq.cu",
            replaces="audio_tokens_tpu/ops/pallas_vq.py:37",
            max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, objective_drift=drift,
            ids_apart_from_highest_fit=apart,
            launches_by_path={f"kmeans_{tier}": launches}))
        del f, got, plain
    del x, x_bf, ids_ref
    torch.cuda.empty_cache()


def tiers_pipelines(records: list, dev, base: Path, cfg, cents) -> None:
    """Phase 8's staged pipeline on its audio with ``use_convolution``
    (B2's sliced instance at d 640) and with the native decoder over the
    int16 wire, each in a workspace of its own, with each stage's seconds
    and launches; the conv run's tokens against the CPU, the native run's
    against phase 8's."""
    import torch

    from audio_tokens_tpu_torch import run_pipeline
    from audio_tokens_tpu_torch.ops.conv_features import ConvFeatures
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.ops.vq import (check_near_ties, l2_normalize,
                                               vq_assign_fused)
    from audio_tokens_tpu_torch.processors import (ClusterCreator,
                                                   ModelTrainer,
                                                   SpecTokenizer,
                                                   SpectrogramGenerator)

    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd,
               lstm_sequence_bwd, tier_sums64)
    stages = (SpectrogramGenerator, ClusterCreator, SpecTokenizer,
              ModelTrainer)
    names = [c.__name__ for c in stages]
    split = json.loads((base / "output" / "bal_train_data_split.json")
                       .read_text())
    variants = (("conv", dict(use_convolution=True)),
                ("native", dict(audio_backend="native", pcm_wire="i16")))
    for tag, over in variants:
        ws = shared_workspace(base, f"tiers_{tag}")
        vcfg = stage_config(ws, **over)
        seconds, launches = {}, {}
        restore = clock_stages(stages, kernels, seconds, launches)
        t0 = time.perf_counter()
        try:
            val_loss, val_metrics = run_pipeline.main(vcfg, dev)
        finally:
            restore()
        run_s = time.perf_counter() - t0
        got = np.load(vcfg.centroids_path)
        log(f"[pipeline {tag}] {over}: "
            + ", ".join(f"{n} {seconds[n]:.2f} s" for n in names)
            + f"; main() {run_s:.2f} s; centroids {got.shape}; val loss "
            f"{val_loss:.6f}, val mAP {val_metrics['mAP']:.6f}; launches B1, "
            "B2, B3, B4, sums by stage: "
            + "; ".join(f"{n} {launches[n]}" for n in names))
        b2_c, b2_t = launches["ClusterCreator"][1], launches["SpecTokenizer"][1]
        b3, b4 = launches["ModelTrainer"][2:4]
        sums_c = launches["ClusterCreator"][4]
        if (b2_c < vcfg.niter or b2_t < 1 or b3 < 1 or b4 < 1
                or sums_c != b2_c or not np.isfinite(val_loss)):
            raise AssertionError(f"pipeline {tag}: launches {launches}, "
                                 f"val loss {val_loss}")
        if got.shape != (vcfg.vocab_size, vcfg.feature_dim) or \
                not np.isfinite(got).all():
            raise AssertionError(f"pipeline {tag}: centroids {got.shape}")
        records[1]["launches_by_path"].update({
            f"pipeline_{tag}_cluster": b2_c, f"pipeline_{tag}_tokenize": b2_t})
        sums_record(records)["launches_by_path"][
            f"pipeline_{tag}_cluster"] = sums_c
        records[2]["launches_by_path"][f"pipeline_{tag}_train"] = b3
        records[3]["launches_by_path"][f"pipeline_{tag}_train"] = b4
        spec_dir = Path(vcfg.dest_spec_path)
        tok_dir = Path(vcfg.dest_tokenized_path)
        if tag == "conv":
            # 8 clips' tokens against the CPU: the saved conv weights and
            # centroids, the plain conv and nearest-centroid search
            conv = ConvFeatures(vcfg.num_kernels, vcfg.kernel_size)
            conv.load_state_dict(dict(np.load(Path(vcfg.centroids_path)
                                              .with_suffix(".conv.npz"))))
            ids = sorted(split["train"])[:8]
            frames = torch.from_numpy(np.concatenate(
                [np.load(spec_dir / "train" / f"{y}.npy").T for y in ids]))
            feats = conv(frames)
            card = torch.from_numpy(np.concatenate(
                [np.load(tok_dir / "train" / f"{y}.npy") for y in ids]))
            c = torch.from_numpy(got)
            frac, gap = check_near_ties(l2_normalize(feats), c, card,
                                        vq_assign_fused(feats, c,
                                                        normalize=True))
            log(f"[pipeline conv reference] 8 clips' tokens (d "
                f"{feats.shape[1]}) card vs CPU: {frac:.2e} apart (gap "
                f"{gap:.3e})")
        else:
            # the card against the CPU with the same decode: 8 clips'
            # spectrograms (clip 0 stereo, clip 5 resampled: the int16
            # wire rounds both) and tokens with the run's centroids
            ids = sorted(split["train"])[:8]
            cpu_cfg = dataclasses.replace(vcfg, device_batch_size=8)
            spec_err, frames = 0.0, []
            for y, spec in SpectrogramGenerator(cpu_cfg, "cpu").iter_specs(
                    ids):
                card = np.load(spec_dir / "train" / f"{y}.npy")
                diff = np.abs(card - spec)
                if card.shape != spec.shape or (
                        diff > SPEC_ATOL + SPEC_RTOL * np.abs(spec)).any():
                    raise AssertionError(f"native i16: {y}'s spectrogram "
                                         f"differs from the CPU's")
                spec_err = max(spec_err, float(diff.max()))
                frames.append(card.T)
            if len(frames) != 8:
                raise AssertionError(f"native i16: {len(frames)} of 8 "
                                     f"spectrograms on the CPU")
            x = torch.from_numpy(np.concatenate(frames))
            card = torch.from_numpy(np.concatenate(
                [np.load(tok_dir / "train" / f"{y}.npy") for y in ids]))
            c = torch.from_numpy(got)
            frac, gap = check_near_ties(l2_normalize(x), c, card,
                                        vq_assign_fused(x, c, normalize=True))
            # beside phase 8 (the f32 wire): another input, so no bound
            a = np.concatenate([np.load(tok_dir / n / f"{y}.npy")
                                for n in split for y in sorted(split[n])])
            b = np.concatenate([np.load(Path(cfg.dest_tokenized_path) / n
                                        / f"{y}.npy")
                                for n in split for y in sorted(split[n])])
            log(f"[pipeline native reference] card vs CPU (native decode, "
                f"int16 wire): 8 spectrograms max abs err {spec_err:.3e} dB "
                f"(atol {SPEC_ATOL} + rtol {SPEC_RTOL}), their tokens "
                f"{frac:.2e} apart (gap {gap:.3e}); beside phase 8's f32 "
                f"wire: centroids max abs diff "
                f"{float(np.abs(got - cents).max()):.3e}, tokens "
                f"{float((a != b).mean()):.3e} apart")
        torch.cuda.empty_cache()


# phase 12: B2 at the bf16 tiers at the shapes the mma.sync design refused
# (label, rows, d, K): the north star's vocabulary, 128 mel bands, the conv
# front-end's width; unit Gaussian rows, centroids drawn from them
TIER_SHAPES = (("K 16384", 110_272, 64, VOCAB_LARGE),
               (f"d {D_WIDE}", 110_272, D_WIDE, VOCAB),
               ("d 640", 882_176, 640, VOCAB))
# KMeans.train at kmeans_precision high at K 16,384: a tenth of a default
# clustering batch's rows, 5 iterations
KMEANS_LARGE_ROWS, KMEANS_LARGE_ITERS = 1_723_000, 5
# the split of the tiered search (tools/kernel_ab.py's ATK_TIER_SPLIT)
TIER_SPLITS = (("no-epilogue", 1), ("no-products", 2), ("staging-only", 3))
_split_procs: list = []


def start_split_builds() -> dict:
    """nvcc for each ATK_TIER_SPLIT build of vq.cu and tokenizer.cu, all
    started together and left to run beside phases 3-11 (the CPU is idle
    there); -> {(source, split): (library, log, process)}."""
    from audio_tokens_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in ("vq", "tokenizer"):
        for name, bit in TIER_SPLITS:
            lib = out / f"lib{src}_{name}.so"
            log_f = open(lib.with_suffix(".log"), "w")
            proc = subprocess.Popen(
                _build.nvcc_command(src, lib, [f"ATK_TIER_SPLIT={bit}"]),
                stdout=log_f, stderr=subprocess.STDOUT)
            _split_procs.append(proc)
            procs[(src, name)] = (lib, log_f, proc)
    return procs


@atexit.register
def _stop_split_builds() -> None:
    for proc in _split_procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def tiers_search(records: list, dev) -> None:
    """B2 at bf16x3 and default at ``TIER_SHAPES`` against its plain tier
    version (``check_tier_ties``) and to its tier against the ``highest``
    ids (``check_follows_tier``), a record each, yardstick ``torch.matmul``
    + argmin in bf16; then ``KMeans.train`` at high at K 16,384."""
    import torch

    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import (vq_argmin, vq_argmin_plain,
                                                    vq_tier_plan)
    from audio_tokens_tpu_torch.ops.tiers import (check_follows_tier,
                                                  check_tier_ties)

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    by_shape = {}
    for label, n, d, k in TIER_SHAPES:
        x = torch.randn((n, d), generator=gen, device=dev)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10
        c = x[torch.randperm(n, generator=gen, device=dev)[:k]].clone()
        highest = vq_argmin(x, c, False)
        c2 = (c * c).sum(1)[None, :]
        x_bf, c_bf = x.to(torch.bfloat16), c.to(torch.bfloat16)

        def matmul_argmin():  # yardstick: bf16 cuBLAS GEMMs, argmin
            step = max(1, (1 << 31) // (4 * k))
            return torch.cat([(c2 - 2.0 * torch.matmul(
                x_bf[i:i + step], c_bf.T).float()).argmin(1)
                for i in range(0, n, step)])

        lib_ms = cuda_ms(matmul_argmin, 3)
        for tier in ("bf16x3", "default"):
            torch.cuda.synchronize()
            vq_argmin.launches = 0
            got = vq_argmin(x, c, False, tier)
            torch.cuda.synchronize()
            launches = vq_argmin.launches
            plain = vq_argmin_plain(x, c, False, tier=tier)
            frac, gap, worst = check_tier_ties(x, c, got, plain, tier)
            flip, followed = check_follows_tier(got, plain, highest, tier,
                                                min_rows=20, band=False)
            ms = cuda_ms(lambda: vq_argmin(x, c, False, tier), 5)
            plain_ms = cuda_ms(lambda: vq_argmin_plain(x, c, False,
                                                       tier=tier), 1)
            b_ms, b_by = tier_bound({tier: 2 * n * k * d},
                                    x.numel() * 4 + n * 4 + c.numel() * 4)
            plan = vq_tier_plan(k, d, tier)
            if launches != 1:
                raise AssertionError(f"B2 {tier} {label}: {launches} "
                                     f"launches")
            log(f"[tiers B2 {tier} {label}] {n} x {d} x {k} "
                f"({plan.instance}, {plan.chunks} chunks of {plan.nc}, "
                f"{plan.slices} slices, {'resident' if plan.resident else f'{plan.stages}-stage ring'}, "
                f"{plan.smem} B shared): {frac:.2e} of the ids apart from "
                f"the plain tier version (largest gap {gap:.3e}, "
                f"{worst:.3f} of its bound), {flip:.3e} apart from highest, "
                f"the plain tier's answer taken where it leaves highest: "
                f"{fmt_share(followed)}; kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
                f"torch.matmul + argmin in bf16 {lib_ms:.3f} ms; launches "
                f"{launches}")
            records.append(dict(
                name=f"B2 vq at tier {tier}, {n} x {d} x {k}",
                route="cuda", source="audio_tokens_tpu_torch/csrc/vq.cu",
                replaces="audio_tokens_tpu/ops/pallas_vq.py:37",
                max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                launches_by_path={
                    f"tiers_b2_{tier}_{label.replace(' ', '')}": launches}))
            by_shape[label, tier] = records[-1]
            del got, plain
        del x, c, highest, x_bf, c_bf
        torch.cuda.empty_cache()
    # the clustering stage's fit at high at the north star's vocabulary
    x = torch.randn((KMEANS_LARGE_ROWS, 64), generator=gen, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10
    fit = km.KMeans(64, VOCAB_LARGE, niter=KMEANS_LARGE_ITERS, seed=0,
                    precision="high", device=dev)
    torch.cuda.synchronize()
    vq_argmin.launches = tier_sums64.launches = 0
    t0 = time.perf_counter()
    fit.train(x)
    torch.cuda.synchronize()
    fit_s, launches = time.perf_counter() - t0, vq_argmin.launches
    if (launches != KMEANS_LARGE_ITERS or not np.isfinite(fit.obj)
            or tier_sums64.launches != launches):
        raise AssertionError(f"KMeans high at K {VOCAB_LARGE}: {launches} "
                             f"launches, objective {fit.obj}")
    log(f"[tiers kmeans K {VOCAB_LARGE}] high: KMeans.train on "
        f"{KMEANS_LARGE_ROWS} x 64, {KMEANS_LARGE_ITERS} iterations, "
        f"{fit_s:.3f} s ({fit_s / KMEANS_LARGE_ITERS * 1e3:.2f} ms an "
        f"iteration), objective {fit.obj:.6f}; launches {launches}")
    by_shape[TIER_SHAPES[0][0], "bf16x3"]["launches_by_path"][
        f"kmeans_high_k{VOCAB_LARGE}"] = launches
    sums_record(records)["launches_by_path"][
        f"kmeans_high_k{VOCAB_LARGE}"] = tier_sums64.launches
    del x, fit
    torch.cuda.empty_cache()


def tiers_split(dev, cfg, procs: dict) -> None:
    """The split of the tiered search: each ATK_TIER_SPLIT build beside
    the default one, B2 at one default clustering batch (17.23M x 64 x 500,
    both tiers) and B1 at K 16,384 (its three combos), in turns."""
    import ctypes

    import torch

    from audio_tokens_tpu_torch.ops import _build, cuda_tokenizer, cuda_vq
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.tools.bench_tokenizer_tiers import COMBOS

    libs = {}
    for key, (lib, log_f, proc) in procs.items():
        rc = proc.wait()
        log_f.close()
        if rc:
            raise RuntimeError(f"nvcc failed for {key}:\n"
                               + lib.with_suffix(".log").read_text())
        cdll = ctypes.CDLL(str(lib))
        cdll.atk_error_string.argtypes = [ctypes.c_int]
        cdll.atk_error_string.restype = ctypes.c_char_p
        libs[key] = cdll
    modules = {"vq": cuda_vq, "tokenizer": cuda_tokenizer}
    default = {src: _build.load(src) for src in modules}
    x = kmeans_rows(cfg, dev)
    c = x[torch.randperm(x.shape[0], device=dev)[:VOCAB]].clone()
    fe = MelFrontend("cpu", SR, cfg.n_mels, cfg.n_fft, cfg.hop_length,
                     cfg.clip_samples)
    wave = torch.from_numpy(fe.prepare_batch(make_clips(BATCH))[0]).to(dev)
    cents = make_centroids(VOCAB_LARGE, 8)
    kerns = {f"{t}/{v}": TokenizerKernel(SR, cfg.n_mels, cfg.n_fft,
                                         cfg.hop_length, fe.frames_max, cents,
                                         dev, t, v)
             for t, v in COMBOS if (t, v) != ("highest", "highest")}
    try:
        for name in ["default"] + [n for n, _ in TIER_SPLITS]:
            for src, mod in modules.items():
                _build._loaded[src] = (default[src] if name == "default"
                                       else libs[(src, name)])
                mod._lib()
            b2 = {t: cuda_ms(lambda t=t: cuda_vq.vq_argmin(x, c, False, t), 3)
                  for t in ("bf16x3", "default")}
            b1 = {combo: cuda_ms(lambda k=k: k(wave), 5)
                  for combo, k in kerns.items()}
            log(f"[tiers split {name}] B2 {x.shape[0]} x 64 x {VOCAB}: "
                + ", ".join(f"{t} {ms:.3f} ms" for t, ms in b2.items())
                + f"; B1 at K {VOCAB_LARGE}: "
                + ", ".join(f"{combo} {ms:.3f} ms" for combo, ms in b1.items()))
    finally:
        for src, mod in modules.items():
            _build._loaded[src] = default[src]
            mod._lib()
    del x, c, wave, kerns
    torch.cuda.empty_cache()


def tiers_phase(records: list, dev, base: Path, cfg, cents,
                python_bench: dict, split_procs: dict) -> None:
    """Phase 12: B1's tier combos, B2's tiers and K-means at them, the conv
    and native pipelines, and ``serve_bench`` with the native decoder for
    tokens and the lstm (beside phase 11's python decode)."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence_fwd
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.tools import serve_bench

    t_phase = time.perf_counter()
    tiers_b1(records, dev)
    tiers_kmeans(records, cfg, dev)
    tiers_search(records, dev)
    tiers_pipelines(records, dev, base, cfg, cents)
    kernels = (TokenizerKernel, lstm_sequence_fwd)
    for tag, extra, must in (("tokens", [], (0,)),
                             ("lstm", ["--classify", "lstm"], (0, 1))):
        argv = ["--n_clips", str(SERVE_BENCH_CLIPS), "--latency",
                str(SERVE_BENCH_LATENCY), "--device", str(dev),
                "--audio_backend", "native", *extra]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        result = serve_bench.main(argv)
        torch.cuda.synchronize()
        launches = [k.launches for k in kernels]
        py = python_bench[tag]
        log(f"[serve_bench native {tag}] {' '.join(argv)}: "
            f"{result['clips_per_s']:.1f} clips/s (python decode, phase 11: "
            f"{py['clips_per_s']:.1f}); a batch of {result['batch']}: decode "
            f"{result['decode_ms']:.1f} ms (python {py['decode_ms']:.1f}); in "
            f"the loop, median {result['decode_loop_ms']:.1f} ms (python "
            f"{py['decode_loop_ms']:.1f}); transfer + card "
            f"{result['device_ms']:.1f} ms; one request p50 "
            f"{result['p50_ms']:.1f} / p99 {result['p99_ms']:.1f} / max "
            f"{result['max_ms']:.1f} ms (python {py['p50_ms']:.1f} / "
            f"{py['p99_ms']:.1f} / {py['max_ms']:.1f}); launches B1, B3 "
            f"{launches}")
        if result["decoder"] != "native" or min(launches[i] for i in must) < 1:
            raise AssertionError(f"serve_bench native {tag}: {result}, "
                                 f"launches {launches}")
        for rec, n in zip((records[0], records[2]), launches):
            if n:
                rec["launches_by_path"][f"serve_bench_native_{tag}"] = n
    tiers_split(dev, cfg, split_procs)
    log(f"[tiers] phase 12 took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")

# -- phase 13: device-resident epochs, the on-card mAP, remat, diagnostics ---
def resident_split(rng, n: int, batch: int, kind: str = "tokens"):
    """A synthetic resident split as ``device_epoch.corpus_arrays`` packs
    one -> (inputs, lengths, labels, n): rows padded to whole batches,
    lengths between half and all of ``max_seq_len`` (zero past them), 1-3
    labels of 543 a clip; uint16 tokens, or f32 (T, n_mels) spec rows."""
    t, n_cls = MODEL["max_seq_len"], MODEL["num_classes"]
    n_pad = -(-n // batch) * batch
    lengths = np.zeros(n_pad, np.int32)
    lengths[:n] = rng.integers(t // 2, t + 1, n)
    labels = np.zeros((n_pad, n_cls), np.uint8)
    for i in range(n):
        labels[i, rng.choice(n_cls, int(rng.integers(1, 4)),
                             replace=False)] = 1
    live = np.arange(t)[None, :] < lengths[:, None]
    if kind == "tokens":
        inputs = (rng.integers(0, VOCAB, (n_pad, t)) * live).astype(np.uint16)
    else:
        inputs = rng.standard_normal((n_pad, t, 64), dtype=np.float32)
        inputs *= live[:, :, None]
    return inputs, lengths, labels, n


def busy_ms(fn, steps: int):
    """``fn`` under ``torch.profiler`` -> (the card's busy ms a step: the
    device time of every kernel and copy the profiler saw, one stream; the
    profiled wall ms a step), or (None, wall) where it saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Activity"):
            continue
        busy += getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0))
    return (busy / 1e3 / steps if busy > 0 else None), wall


def device_map_check(dev) -> None:
    """The on-card exact mAP at the balanced split's size (scores on a
    1/MAP_QUANT grid: ties) against the host's exact mAP, and the binned
    metric at MAP_BINS bins against the host ``StreamingMAP``."""
    import torch

    from audio_tokens_tpu_torch.utils.device_metrics import (
        binned_map_init, binned_map_result, binned_map_update,
        macro_map_device)
    from audio_tokens_tpu_torch.utils.metrics import (
        StreamingMAP, macro_mean_average_precision)

    rng = np.random.default_rng(31)
    _, _, labels, n = resident_split(rng, EPOCH_TRAIN, B_LSTM)
    n_pad, n_cls = labels.shape
    scores = (np.round(rng.random((n_pad, n_cls)) * MAP_QUANT)
              / MAP_QUANT).astype(np.float32)
    s, y = torch.from_numpy(scores).to(dev), torch.from_numpy(labels).to(dev)
    valid = torch.arange(n_pad, device=dev) < n
    got = float(macro_map_device(s, y, valid))
    ms = cuda_ms(lambda: macro_map_device(s, y, valid), 3)
    t0 = time.perf_counter()
    want = macro_mean_average_precision(labels[:n], scores[:n])
    host_s = time.perf_counter() - t0
    err = abs(got - want)
    hist = binned_map_init(n_cls, MAP_BINS, dev)
    rows_w = valid.float()
    for lo in range(0, n_pad, B_LSTM):
        sl = slice(lo, lo + B_LSTM)
        binned_map_update(hist, s[sl], y[sl], rows_w[sl])
    binned = float(binned_map_result(hist))
    host = StreamingMAP(n_cls, bins=MAP_BINS)
    host.update(labels[:n], scores[:n])
    counts_equal = (np.array_equal(hist[0].cpu().numpy(), host.pos)
                    and np.array_equal(hist[1].cpu().numpy(), host.neg))
    b_err = abs(binned - host.result()["mAP"])
    log(f"[device map] macro_map_device at {n} rows ({n_pad} padded) x "
        f"{n_cls} classes, scores on a 1/{MAP_QUANT} grid (ties): "
        f"{got:.8f} vs the host's exact mAP {want:.8f}, |diff| {err:.3e} "
        f"(bound 1e-6); {ms:.3f} ms on the card (CUDA events) against "
        f"{host_s * 1e3:.1f} ms on the host; binned at {MAP_BINS} bins "
        f"(updates of {B_LSTM} rows): {binned:.8f}, counts equal to "
        f"StreamingMAP's: {counts_equal}, |diff| {b_err:.3e}")
    if not (err <= 1e-6 and counts_equal and b_err <= 1e-6):
        raise AssertionError("the on-card mAP disagrees with the host's")


def device_epoch_family(records, dev, tag: str, cfg, splits: dict,
                        steps: int, kernels: dict, materialize=False):
    """One family's device-resident epochs on a resident corpus: a warm-up
    of 2 steps, ``steps`` timed steps (0: the rest of a whole epoch) and the
    eval epoch, each with its launches of ``kernels`` and its reads of the
    card; an epoch of 2 x ``steps`` (the marginal ms of a step: the
    difference over ``steps``); then PROFILE_STEPS steps under the profiler
    for the card's busy time.  Returns {path: [launches]}."""
    import torch

    from audio_tokens_tpu_torch.train import device_epoch
    from audio_tokens_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, dev)
    runner = device_epoch.DeviceEpochRunner(trainer, materialize)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for split, arrays in splits.items():
        runner.set_corpus_arrays(split, *arrays, cfg.training_batch_size)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    resident = sum(t.numel() * t.element_size()
                   for c in runner.corpora.values()
                   for t in (c.inputs, c.lengths, c.labels))
    reads = []
    read = device_epoch.read_scalars

    def counted(*values):
        reads.append(len(values))
        return read(*values)

    device_epoch.read_scalars = counted
    try:
        runner.train_epoch(0, 0, max_steps=2)  # warm-up
        n_steps = steps or runner.corpora["train"].n_steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        reads.clear()
        t0 = time.perf_counter()
        step, loss, m = runner.train_epoch(1, 2, max_steps=2 + steps
                                           if steps else 0)
        wall = (time.perf_counter() - t0) * 1e3
        launches = {"train": [k.launches for k in kernels.values()]}
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        val_loss, val_m = runner.eval_epoch()
        eval_s = time.perf_counter() - t0
        launches["eval"] = [k.launches for k in kernels.values()]
        peak = torch.cuda.max_memory_allocated() / 2**30
        epoch_reads = list(reads)
        marginal = None
        if steps:
            t0 = time.perf_counter()
            step = runner.train_epoch(2, step, max_steps=step + 2 * steps)[0]
            marginal = ((time.perf_counter() - t0) * 1e3 - wall) / steps
        busy, prof_wall = busy_ms(lambda: runner.train_epoch(
            3, step, max_steps=step + PROFILE_STEPS), PROFILE_STEPS)
    finally:
        device_epoch.read_scalars = read
    ms = wall / n_steps
    step_ms = marginal if marginal is not None else ms
    stream = STREAM_STEP_MS.get(tag)
    n_eval = runner.corpora["validation"].n_steps
    log(f"[device epoch {tag}] {n_steps} steps of "
        f"{cfg.training_batch_size} on a resident corpus of "
        f"{runner.corpora['train'].n_real} + "
        f"{runner.corpora['validation'].n_real} clips ({resident / 1e6:.1f} "
        f"MB on the card, uploaded in {upload_s:.2f} s"
        + (", the epoch gather" if materialize else "")
        + f"): {ms:.3f} ms a step (host clock over the epoch, no sync "
        f"inside; loss {loss:.6f}, mAP {m['mAP']:.6f})"
        + (f", {marginal:.3f} ms marginal (an epoch of {2 * steps} steps "
           f"less this one, over {steps})" if marginal is not None else "")
        + "; the card busy "
        + (f"{busy:.3f} ms" if busy is not None else "not measured")
        + f" a step over {PROFILE_STEPS} profiled steps (profiled wall "
        f"{prof_wall:.3f} ms a step"
        + (f"; host gap of the unprofiled step "
           f"{max(0.0, step_ms - busy):.3f} ms, idle "
           f"{max(0.0, 1 - busy / step_ms):.1%}" if busy is not None
           else "")
        + "); streaming step in this run "
        + (f"{stream:.2f} ms" if stream is not None else "not measured")
        + f"; eval epoch {n_eval} steps {eval_s * 1e3:.1f} ms (val loss "
        f"{val_loss:.6f}, mAP {val_m['mAP']:.6f}); peak device memory "
        f"{peak:.2f} GiB; reads of the card: {epoch_reads} scalars an "
        f"epoch; launches "
        + (", ".join(f"{name} train {launches['train'][i]} eval "
                     f"{launches['eval'][i]}"
                     for i, name in enumerate(kernels))
           or "none (no kernel of its own)"))
    if epoch_reads != [2, 2] or not (np.isfinite(loss)
                                     and np.isfinite(val_loss)):
        raise AssertionError(f"{tag}: reads {epoch_reads}, loss {loss}, "
                             f"val loss {val_loss}")
    for name, i in ((n, j) for j, n in enumerate(kernels)):
        if launches["train"][i] + launches["eval"][i] < 1:
            raise AssertionError(f"{tag}: {name} never launched")
    del trainer, runner
    torch.cuda.empty_cache()
    return launches


def device_trajectory(dev, base: Path) -> None:
    """The full-width lstm (dropout 0.1) through ``Trainer.run()``: the
    device epoch against streaming over TRAJ_EPOCHS epochs of a corpus
    whose splits end in a partial batch; per-epoch loss (rel), mAP (abs)
    and the final weights (rtol + atol)."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.train.trainer import Trainer

    write_token_corpus(base, 13, TRAJ_TRAIN, TRAJ_VAL)
    out = {}
    for mode in ("off", "on"):
        cfg = AudioTokensConfig(
            base_dir=str(base), **MODEL, training_batch_size=B_LSTM,
            epochs=TRAJ_EPOCHS, dropout=0.1, num_workers=2,
            log_every_steps=0, device_corpus=mode,
            save_best_checkpoint=False,
            checkpoint_dir=str(base / f"ckpt_{mode}"))
        trainer = Trainer(cfg, dev)
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        hist = [json.loads(x) for x in (
            Path(cfg.checkpoint_dir) / "no-wandb-metrics.jsonl"
        ).read_text().splitlines()]
        out[mode] = (hist, {k: v.cpu() for k, v in
                            trainer.model.state_dict().items()},
                     time.perf_counter() - t0)
        del trainer
    (h_on, s_on, on_s), (h_off, s_off, off_s) = out["on"], out["off"]
    loss_gap = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(h_on, h_off)
                   for k in ("train_loss", "val_loss"))
    map_gap = max(abs(a[k] - b[k]) for a, b in zip(h_on, h_off)
                  for k in ("train_mAP", "val_mAP"))
    over = max(float(((s_on[k] - s_off[k]).abs()
                      - TRAJ_PARAM_RTOL * s_off[k].abs()).max())
               for k in s_off)
    param_gap = max(float((s_on[k] - s_off[k]).abs().max()) for k in s_off)
    log(f"[device trajectory] lstm {MODEL['lstm_embed_dim']}/"
        f"{MODEL['lstm_hidden_dim']}, dropout 0.1, {TRAJ_EPOCHS} epochs of "
        f"{TRAJ_TRAIN} + {TRAJ_VAL} clips at batch {B_LSTM} (partial last "
        f"batches), Trainer.run() device epoch ({on_s:.1f} s) vs streaming "
        f"({off_s:.1f} s): largest loss gap {loss_gap:.3e} relative (bound "
        f"{TRAJ_LOSS_RTOL}), mAP gap {map_gap:.3e} (bound {TRAJ_MAP_ATOL}), "
        f"weights {param_gap:.3e} abs (bound {TRAJ_PARAM_ATOL} + "
        f"{TRAJ_PARAM_RTOL} relative)")
    if (len(h_on) != TRAJ_EPOCHS or loss_gap > TRAJ_LOSS_RTOL
            or map_gap > TRAJ_MAP_ATOL or over > TRAJ_PARAM_ATOL):
        raise AssertionError("the device epoch left the streaming "
                             "trajectory")


def remat_step(model, batch, gen=None):
    """One training step (weighted BCE, backward, AdamW) closure."""
    import torch

    from audio_tokens_tpu_torch.train.objective import weighted_bce

    x, ln, y, w = batch
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        weighted_bce(model(x, ln, generator=gen), y, w).backward()
        opt.step()

    return step


def remat_phase(records, dev) -> None:
    """B3 in chunks from carries at the full shape (bit-equal to one
    launch, and its time), then lstm_remat_chunk and transformer_remat
    steps at full width beside the runs without them: ms a step, peak
    memory, gradients against the run without remat."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_carry,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    gen = torch.Generator().manual_seed(41)
    xg = torch.randn((T_LSTM, B_LSTM, 4 * H_LSTM), generator=gen).to(dev)
    w_hh = ((torch.rand((H_LSTM, 4 * H_LSTM), generator=gen) * 2 - 1)
            / H_LSTM ** 0.5).to(dev)
    lens = torch.randint(1, T_LSTM + 1, (B_LSTM,), generator=gen)
    mask = (torch.arange(T_LSTM)[:, None] < lens[None, :]).float().to(dev)

    def chunked(s, reverse):
        starts = range(0, T_LSTM, s)
        h = c = None
        hs = {}
        for t0 in (reversed(starts) if reverse else starts):
            hs[t0], h, c = lstm_sequence_carry(
                xg[t0:t0 + s], mask[t0:t0 + s], w_hh, reverse, h, c)
        return torch.cat([hs[t0] for t0 in starts]), h, c

    with torch.no_grad():
        whole = {r: lstm_sequence_carry(xg, mask, w_hh, r)
                 for r in (False, True)}
        equal = all(torch.equal(a, b) for s in REMAT_CHUNKS
                    for r in (False, True)
                    for a, b in zip(chunked(s, r), whole[r]))
        whole_ms = cuda_ms(lambda: [lstm_sequence_carry(xg, mask, w_hh, r)
                                    for r in (False, True)], 3)
        chunk_ms = {s: cuda_ms(lambda s=s: [chunked(s, r)
                                            for r in (False, True)], 3)
                    for s in REMAT_CHUNKS}
    log(f"[remat B3 chunks] T {T_LSTM} B {B_LSTM} H {H_LSTM}, both "
        f"directions, each time chunk from the last one's (h_last, "
        f"c_last): hs, h_last, c_last bit-equal to one launch at chunks of "
        + " and ".join(map(str, REMAT_CHUNKS)) + f": {equal}; one launch "
        f"{whole_ms:.3f} ms, chunked "
        + ", ".join(f"{s}: {ms:.3f} ms ({-(-T_LSTM // s)} launches a "
                    f"direction)" for s, ms in chunk_ms.items()))
    if not equal:
        raise AssertionError("chunked B3 is not bit-equal to one launch")
    records[2]["chunked_ms"] = {str(s): ms for s, ms in chunk_ms.items()}
    del xg, w_hh, mask, whole

    # lstm_remat_chunk at batch 64 and T 1728, full width
    t = MODEL["max_seq_len"]
    x = torch.randint(0, VOCAB, (B_LSTM, t), generator=gen).to(dev)
    ln = torch.randint(t // 2, t + 1, (B_LSTM,), generator=gen).to(dev)
    y = (torch.rand((B_LSTM, MODEL["num_classes"]), generator=gen)
         < 0.005).float().to(dev)
    w = torch.ones(B_LSTM, device=dev)
    ref = None
    for chunk in (0, *REMAT_CHUNKS):
        cfg = AudioTokensConfig(**MODEL, lstm_remat_chunk=chunk)
        model = get_model(cfg, dev, torch.Generator().manual_seed(0))
        lstm_sequence_fwd.launches = lstm_sequence_bwd.launches = 0
        model.zero_grad(set_to_none=True)
        weighted_bce(model(x, ln), y, w).backward()
        launches = [lstm_sequence_fwd.launches, lstm_sequence_bwd.launches]
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        step = remat_step(model, (x, ln, y, w))
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, REMAT_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if ref is None:
            ref = (grads, ms, peak)
            worst = 0.0
        else:
            worst = max(float(((g - ref[0][n]).abs()
                               - GRAD_RTOL * ref[0][n].abs()).max())
                        for n, g in grads.items())
            records[2]["launches_by_path"][f"remat_lstm_{chunk}"] = \
                launches[0]
            records[3]["launches_by_path"][f"remat_lstm_{chunk}"] = \
                launches[1]
        log(f"[remat lstm] lstm_remat_chunk {chunk} at batch {B_LSTM}, T "
            f"{t}: {ms:.2f} ms a step (CUDA events, loss + backward + "
            f"AdamW), peak device memory {peak:.2f} GiB"
            + (f" (no remat {ref[1]:.2f} ms, {ref[2]:.2f} GiB); gradients "
               f"vs no remat: largest excess over {GRAD_RTOL} relative "
               f"{worst:.3e} (bound {GRAD_ATOL})" if chunk else "")
            + f"; a loss + backward launched B3 {launches[0]}, B4 "
            f"{launches[1]}")
        if chunk and (worst > GRAD_ATOL or not peak < ref[2]):
            raise AssertionError(f"remat chunk {chunk}: gradients off by "
                                 f"{worst:.3e} or peak {peak:.2f} GiB")
        del model, step, grads
        torch.cuda.empty_cache()

    # transformer_remat at bert_full's widths, batch 8: timed at the
    # phase-7 configuration (dropout 0), gradients with dropout 0.1
    bx = x[:B_BERT_TRAIN]
    bt = (bx, ln[:B_BERT_TRAIN], y[:B_BERT_TRAIN], w[:B_BERT_TRAIN])
    out = {}
    for remat in (False, True):
        timed = {}
        for rate in (0.0, 0.1):
            cfg = AudioTokensConfig(**{**BERT, "dropout": rate},
                                    transformer_remat=remat)
            model = get_model(cfg, dev, torch.Generator().manual_seed(0))
            model.train()
            dgen = torch.Generator(device=dev).manual_seed(5)
            if rate:
                model.zero_grad(set_to_none=True)
                weighted_bce(model(bx, bt[1], generator=dgen), bt[2],
                             bt[3]).backward()
                timed["grads"] = {n: p.grad.detach().float().clone()
                                  for n, p in model.named_parameters()}
            else:
                step = remat_step(model, bt, dgen)
                step()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                timed["ms"] = cuda_ms(step, REMAT_STEPS)
                timed["peak"] = torch.cuda.max_memory_allocated() / 2**30
                del step
            del model
            torch.cuda.empty_cache()
        out[remat] = timed
    ref, got = out[False], out[True]
    worst = max(float(((g - ref["grads"][n]).abs()
                       - GRAD_RTOL * ref["grads"][n].abs()).max())
                for n, g in got["grads"].items())
    equal = all(torch.equal(g, ref["grads"][n])
                for n, g in got["grads"].items())
    stream = STREAM_STEP_MS.get("bert")
    log(f"[remat bert] transformer_remat at hidden {BERT['hidden_size']} x "
        f"{BERT['num_layers']} layers, window "
        f"{BERT['transformer_max_position']}, bfloat16, batch "
        f"{B_BERT_TRAIN}, dropout 0: {got['ms']:.2f} ms a step (CUDA events, "
        f"loss + backward + AdamW), peak device memory {got['peak']:.2f} "
        f"GiB; without remat {ref['ms']:.2f} ms, {ref['peak']:.2f} GiB "
        f"(phase 7's streaming step "
        + (f"{stream:.2f} ms" if stream is not None else "not measured")
        + f"); gradients with dropout 0.1 (the same generator seed) "
        f"bit-equal: {equal}, largest excess over {GRAD_RTOL} relative "
        f"{worst:.3e} (bound {GRAD_ATOL})")
    if worst > GRAD_ATOL or not got["peak"] < ref["peak"]:
        raise AssertionError("transformer_remat: gradients or peak")


def diagnostics_check(dev, base: Path) -> None:
    """One ``diagnostics_every=1`` epoch on the card (device-resident, 2
    steps of DIAG_BATCH) on the trajectory corpus: the hook's gradient-flow
    report held to the CPU's on the same batch and weights (each mean and
    max |grad| within 1e-3 relative)."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.train.trainer import Trainer
    from audio_tokens_tpu_torch.utils import diagnostics

    seen = {}
    real_flow, real_loss = diagnostics.gradient_flow, diagnostics.make_batch_loss

    def flow(loss_fn, params, plot_path=None):
        seen["report"] = real_flow(loss_fn, params, plot_path)
        seen["plot"] = plot_path
        return seen["report"]

    def batch_loss(model, batch, use_lengths, device):
        seen["batch"] = batch
        return real_loss(model, batch, use_lengths, device)

    diagnostics.gradient_flow, diagnostics.make_batch_loss = flow, batch_loss
    try:
        cfg = AudioTokensConfig(
            base_dir=str(base), **MODEL, training_batch_size=DIAG_BATCH,
            epochs=1, max_train_steps=2, diagnostics_every=1, num_workers=2,
            log_every_steps=0, save_best_checkpoint=False,
            checkpoint_dir=str(base / "ckpt_diag"))
        trainer = Trainer(cfg, dev)
        t0 = time.perf_counter()
        trainer.run()
        run_s = time.perf_counter() - t0
    finally:
        diagnostics.gradient_flow = real_flow
        diagnostics.make_batch_loss = real_loss
    cpu = get_model(cfg, "cpu", torch.Generator().manual_seed(0))
    cpu.load_state_dict({k: v.cpu() for k, v in
                         trainer.model.state_dict().items()})
    want = real_flow(real_loss(cpu, seen["batch"], True, "cpu"),
                     dict(cpu.named_parameters()))
    got = seen["report"]
    worst = max(abs(got[n][k] - want[n][k]) / max(abs(want[n][k]), 1e-30)
                for n in want for k in ("mean_abs_grad", "max_abs_grad"))
    log(f"[diagnostics] diagnostics_every=1 on the card ({run_s:.1f} s, a "
        f"device-resident epoch of 2 steps): {len(got)} parameters' "
        f"mean/max |grad| against the CPU's on the same batch and weights, "
        f"largest relative gap {worst:.3e} (bound 1e-3); chart "
        f"{Path(seen['plot']).name} written: "
        f"{Path(seen['plot']).exists()} (needs matplotlib)")
    if sorted(got) != sorted(want) or worst > 1e-3:
        raise AssertionError(f"gradient-flow report differs: {worst:.3e}")
    del trainer, cpu


def device_phase(records: list, dev, base: Path) -> None:
    """Phase 13: the on-card mAP, device-resident epochs of the lstm,
    simple, bert and cnn at full width, the device epoch against streaming,
    the remat options, one diagnostics epoch."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)

    t_phase = time.perf_counter()
    device_map_check(dev)
    rng = np.random.default_rng(32)
    tokens = {"train": resident_split(rng, EPOCH_TRAIN, B_LSTM),
              "validation": resident_split(rng, EPOCH_VAL, B_LSTM)}
    lstm_k = {"B3": lstm_sequence_fwd, "B4": lstm_sequence_bwd}
    cfg = AudioTokensConfig(**MODEL, training_batch_size=B_LSTM,
                            log_every_steps=0)
    got = device_epoch_family(records, dev, "lstm", cfg, tokens,
                              EPOCH_STEPS, lstm_k)
    records[2]["launches_by_path"].update(
        device_epoch_lstm=got["train"][0], device_eval_lstm=got["eval"][0])
    records[3]["launches_by_path"]["device_epoch_lstm"] = got["train"][1]
    device_epoch_family(records, dev, "simple", dataclasses.replace(
        cfg, **FAMILIES["simple"]), tokens, 0, {})
    bert_split = {
        "train": tokens["train"],
        "validation": tuple(a[:BERT_EVAL] for a in tokens["validation"][:3])
        + (BERT_EVAL,)}
    got = device_epoch_family(
        records, dev, "bert", AudioTokensConfig(
            **BERT, training_batch_size=B_BERT_TRAIN, log_every_steps=0),
        bert_split, BERT_STEPS, {"B5": flash_attention_fwd})
    records[4]["launches_by_path"]["device_eval_bert"] = got["eval"][0]
    del tokens, bert_split
    spec = {"train": resident_split(rng, SPEC_TRAIN, B_LSTM, "spec"),
            "validation": resident_split(rng, SPEC_VAL, B_LSTM, "spec")}
    device_epoch_family(records, dev, "cnn", dataclasses.replace(
        cfg, **FAMILIES["cnn"], device_corpus_dtype="bfloat16"), spec,
        EPOCH_STEPS, {}, materialize=True)
    del spec
    torch.cuda.empty_cache()
    device_trajectory(dev, base)
    remat_phase(records, dev)
    diagnostics_check(dev, base)
    log(f"[device] phase 13 took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")



# -- phase 14: ensembles and LR sweeps (train/ensemble.py) ---------------------
def ensemble_splits(cfg, batch: int, seed: int, n_batches: int = 0,
                    n_val: int = 0) -> dict:
    """``tools/bench_training.synthetic_corpus``'s corpus: ``n_batches``
    (ENS_BATCHES) x ``batch`` training rows and ``n_val`` (ENS_VAL)
    validation rows, seeded."""
    from audio_tokens_tpu_torch.tools.bench_training import synthetic_corpus

    rng = np.random.default_rng(seed)
    n = (n_batches or ENS_BATCHES) * batch
    n_val = n_val or ENS_VAL
    return {"train": (*synthetic_corpus(cfg, batch, n, rng), n),
            "validation": (*synthetic_corpus(cfg, batch, n_val, rng), n_val)}


def ensemble_epochs(dev, cfg, k: int, splits: dict, kernels: dict,
                    seeds=None, epochs: int = 2, sync_check: bool = False,
                    profile: bool = False) -> dict:
    """``EnsembleTrainer`` of ``k`` members on ``splits``: ``epochs``
    training epochs (the first warms up; with ``sync_check`` it runs under
    ``torch.cuda.set_sync_debug_mode("error")`` but its one read), then
    the eval epoch.  The last training epoch and the eval epoch are timed
    on the host clock (each ends in its read of the card) with the launch
    counters reset before and read after each; peak memory over both.
    ``profile``: one more epoch under the profiler for the card's busy
    time.  Returns the numbers, the trainer and its state."""
    import torch

    from audio_tokens_tpu_torch.train import device_epoch
    from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer

    ens = EnsembleTrainer(cfg, dev, n_models=k, seeds=seeds)
    for split, arrays in splits.items():
        ens.set_corpus_arrays(split, *arrays, cfg.training_batch_size)
    params, opt_state = ens.init_state()
    out = {"reads": [], "history": []}
    read = device_epoch.read_scalars

    def let_through(*values):
        torch.cuda.set_sync_debug_mode(0)
        try:
            out["reads"].append(len(values))
            return read(*values)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    step = 0
    for epoch in range(epochs):
        last = epoch == epochs - 1
        torch.cuda.synchronize()
        if last:
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels.values():
                kern.launches = 0
        if sync_check and epoch == 0:
            device_epoch.read_scalars = let_through
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            params, opt_state, step, *train = ens.train_epoch(
                params, opt_state, epoch, step)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            device_epoch.read_scalars = read
        out["history"].append(train)
        if last:
            out["train_ms"] = (time.perf_counter() - t0) * 1e3
    out["train_launches"] = [kern.launches for kern in kernels.values()]
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out["eval"] = ens.eval_epoch(params)
    out["eval_ms"] = (time.perf_counter() - t0) * 1e3
    out["eval_launches"] = [kern.launches for kern in kernels.values()]
    out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        n_steps = ens.corpora["train"].n_steps
        busy, wall = busy_ms(lambda: ens.train_epoch(params, opt_state,
                                                     epochs, step), n_steps)
        out["busy"], out["prof_wall"] = busy, wall
    out.update(trainer=ens, params=params)
    return out


def ensemble_line(tag: str, k: int, got: dict, one: dict, kernels: dict,
                  card: str) -> str:
    """One ``[ensemble <tag>]`` line: the K-member epoch beside the
    1-member one."""
    n_steps = got["trainer"].corpora["train"].n_steps
    cost = got["train_ms"] / (k * one["train_ms"])
    losses, per, ens_map = got["history"][-1]
    val_loss, val_map, val_ens = got["eval"]
    text = (f"[ensemble {tag}] K {k}: a training epoch of {n_steps} steps "
            f"{got['train_ms']:.1f} ms ({got['train_ms'] / n_steps:.2f} ms a "
            f"step) against K 1 {one['train_ms']:.1f} ms: cost a member "
            f"t_K / (K t_1) {cost:.3f} (the JAX tool's speed-up "
            f"{1 / cost:.2f}x); eval epoch {got['eval_ms']:.1f} ms (K 1 "
            f"{one['eval_ms']:.1f}); peak device memory {got['peak']:.2f} "
            f"GiB (K 1 {one['peak']:.2f}); train loss per member "
            f"{np.round(losses, 6).tolist()}, mAP {np.round(per, 6).tolist()}"
            f", ensemble mAP {ens_map:.6f}; val mAP per member "
            f"{np.round(val_map, 6).tolist()}, ensemble {val_ens:.6f}")
    if kernels:
        text += "; launches " + ", ".join(
            f"{name} train {got['train_launches'][i]} (K 1 "
            f"{one['train_launches'][i]}) eval {got['eval_launches'][i]} "
            f"(K 1 {one['eval_launches'][i]})"
            for i, name in enumerate(kernels))
    if got.get("busy") is not None:
        step = got["train_ms"] / n_steps
        text += (f"; the card busy {got['busy']:.3f} ms a step under the "
                 f"profiler (profiled wall {got['prof_wall']:.3f}), idle "
                 f"{max(0.0, 1 - got['busy'] / step):.1%} of the unprofiled "
                 f"step")
    elif "busy" in got:
        text += "; the card's busy time not measured (no device time seen)"
    return text + f"; {card}"


def member_vs_single(dev, cfg, splits: dict, got: dict) -> tuple:
    """Member 0 of ``got`` (seed ``cfg.random_seed``) against a single
    ``DeviceEpochRunner`` of that seed over the same epochs -> (the largest
    loss gap, relative; mAP gap; the weights' largest excess over
    TRAJ_PARAM_RTOL relative)."""
    from audio_tokens_tpu_torch.train.device_epoch import DeviceEpochRunner
    from audio_tokens_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, dev)
    runner = DeviceEpochRunner(trainer)
    for split, arrays in splits.items():
        runner.set_corpus_arrays(split, *arrays, cfg.training_batch_size)
    step, loss_gap, map_gap = 0, [], []
    for epoch, (losses, per, _) in enumerate(got["history"]):
        step, loss, m = runner.train_epoch(epoch, step)
        loss_gap.append(abs(losses[0] - loss) / abs(loss))
        map_gap.append(abs(per[0] - m["mAP"]))
    val_loss, val_m = runner.eval_epoch()
    loss_gap.append(abs(got["eval"][0][0] - val_loss) / abs(val_loss))
    map_gap.append(abs(got["eval"][1][0] - val_m["mAP"]))
    member = got["trainer"].member_params(got["params"], 0)
    over = max(float(((member[n] - p.detach()).abs()
                      - TRAJ_PARAM_RTOL * p.detach().abs()).max())
               for n, p in trainer.model.named_parameters())
    del trainer, runner
    return max(loss_gap), max(map_gap), over


def ensemble_main(records, dev, base: Path, card: str) -> None:
    """The slice's entry point as a user calls it: ``python -m
    audio_tokens_tpu_torch.train.ensemble`` (``ensemble.main``) on a token
    workspace, the default lstm, 4 members, one epoch, its launches."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train import ensemble

    write_token_corpus(base, 17, TRAIN_CLIPS, VAL_CLIPS)
    lstm_sequence_fwd.launches = lstm_sequence_bwd.launches = 0
    t0 = time.perf_counter()
    report = ensemble.main([
        "--device", str(dev), "--n_models", str(ENS_K["lstm"]),
        "--base_dir", str(base), "--epochs", "1", "--dropout", "0.1",
        "--training_batch_size", str(B_LSTM), "--num_workers", "2",
        "--log_every_steps", "0", *(f"--{k}={v}" for k, v in MODEL.items())])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = [lstm_sequence_fwd.launches, lstm_sequence_bwd.launches]
    records[2]["launches_by_path"]["ensemble_main_lstm"] = launches[0]
    records[3]["launches_by_path"]["ensemble_main_lstm"] = launches[1]
    log(f"[ensemble main] python -m audio_tokens_tpu_torch.train.ensemble "
        f"--n_models {ENS_K['lstm']} on {TRAIN_CLIPS} + {VAL_CLIPS} token "
        f"clips, lstm {MODEL['lstm_embed_dim']}/{MODEL['lstm_hidden_dim']}, "
        f"dropout 0.1, 1 epoch: {run_s:.1f} s (host clock, corpus packing "
        f"and checkpoints included); best member {report['best_member']} "
        f"val mAP {report['best_member_val_mAP']:.6f}, ensemble "
        f"{report['ensemble_val_mAP']:.6f}; launches B3 {launches[0]}, B4 "
        f"{launches[1]}; {card}")
    steps = -(-TRAIN_CLIPS // B_LSTM), -(-VAL_CLIPS // B_LSTM)
    want = [ENS_K["lstm"] * 2 * sum(steps), ENS_K["lstm"] * 2 * steps[0]]
    if launches != want or not 0.0 <= report["ensemble_val_mAP"] <= 1.0:
        raise AssertionError(f"ensemble main: launches {launches} (want "
                             f"{want}), ensemble mAP "
                             f"{report['ensemble_val_mAP']}")


def ensemble_phase(records: list, dev, base: Path) -> None:
    """Phase 14: ensembles and LR sweeps at full width (see the module's
    docstring)."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train.objective import model_inputs

    t_phase = time.perf_counter()
    card = f"{card_line()} (nvidia-smi)"
    ensemble_main(records, dev, base, card)

    # the lstm at full width with dropout, K 1 and K 4
    lstm_k = {"B3": lstm_sequence_fwd, "B4": lstm_sequence_bwd}
    cfg = AudioTokensConfig(**MODEL, training_batch_size=B_LSTM, dropout=0.1,
                            log_every_steps=0)
    k = ENS_K["lstm"]
    splits = ensemble_splits(cfg, B_LSTM, 41)
    one = ensemble_epochs(dev, cfg, 1, splits, lstm_k)
    del one["trainer"], one["params"]
    got = ensemble_epochs(dev, cfg, k, splits, lstm_k, sync_check=True)
    log(ensemble_line("lstm", k, got, one, lstm_k, card))
    loss_gap, map_gap, over = member_vs_single(dev, cfg, splits, got)
    log(f"[ensemble lstm] member 0 (seed {cfg.random_seed}) against a single "
        f"DeviceEpochRunner of that seed over {len(got['history'])} epochs "
        f"and the eval epoch, dropout 0.1: loss gap {loss_gap:.3e} relative "
        f"(bound {TRAJ_LOSS_RTOL}), mAP gap {map_gap:.3e} (bound "
        f"{TRAJ_MAP_ATOL}), weights' excess over {TRAJ_PARAM_RTOL} relative "
        f"{over:.3e} (bound {TRAJ_PARAM_ATOL}); the first epoch under "
        f"set_sync_debug_mode('error'): reads of the card {got['reads']} "
        f"scalars (2K + 1 = {2 * k + 1})")
    for path, i in (("train", 0), ("eval", 0), ("train", 1)):
        if got[f"{path}_launches"][i] != k * one[f"{path}_launches"][i]:
            raise AssertionError(f"ensemble lstm: {path} launches "
                                 f"{got[f'{path}_launches']} against K x "
                                 f"{one[f'{path}_launches']}")
    if (loss_gap > TRAJ_LOSS_RTOL or map_gap > TRAJ_MAP_ATOL
            or over > TRAJ_PARAM_ATOL or got["reads"] != [2 * k + 1]):
        raise AssertionError(f"ensemble lstm: member 0 off the single run, "
                             f"or reads {got['reads']}")
    for rec, i in ((records[2], 0), (records[3], 1)):
        rec["launches_by_path"][f"ensemble_lstm_k{k}"] = \
            got["train_launches"][i]
    records[2]["launches_by_path"][f"ensemble_eval_lstm_k{k}"] = \
        got["eval_launches"][0]
    plain_peak, plain_hist = got["peak"], got["history"]
    del got
    torch.cuda.empty_cache()

    # the same K 4 ensemble with lstm_remat_chunk
    rcfg = dataclasses.replace(cfg, lstm_remat_chunk=ENS_REMAT_CHUNK)
    remat = ensemble_epochs(dev, rcfg, k, splits, lstm_k)
    gap = max(max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                               / np.maximum(np.abs(np.asarray(b)), 1e-12)))
                  for a, b in zip(ra, pa))
              for ra, pa in zip(remat["history"], plain_hist))
    log(f"[ensemble lstm remat] K {k}, lstm_remat_chunk {ENS_REMAT_CHUNK}: "
        f"a training epoch {remat['train_ms']:.1f} ms, peak device memory "
        f"{remat['peak']:.2f} GiB against {plain_peak:.2f} without remat; "
        f"trajectory (losses, mAPs, ensemble mAP) within {gap:.3e} relative "
        f"of the run without (bound {ENS_TOL}); launches B3 train "
        f"{remat['train_launches'][0]} eval {remat['eval_launches'][0]}, B4 "
        f"{remat['train_launches'][1]}; {card}")
    if gap > ENS_TOL or not remat["peak"] < plain_peak:
        raise AssertionError("ensemble remat: trajectory or peak memory")
    records[2]["launches_by_path"][f"ensemble_remat_lstm_k{k}"] = \
        remat["train_launches"][0]
    records[3]["launches_by_path"][f"ensemble_remat_lstm_k{k}"] = \
        remat["train_launches"][1]
    del remat
    torch.cuda.empty_cache()

    # simple (hidden 768): K 1 and K 8, the card's busy share
    scfg = dataclasses.replace(cfg, **FAMILIES["simple"], dropout=0.0)
    k = ENS_K["simple"]
    s_splits = ensemble_splits(scfg, B_LSTM, 42)
    one = ensemble_epochs(dev, scfg, 1, s_splits, {}, profile=True)
    log(ensemble_line("simple K 1", 1, one, one, {}, card))
    got = ensemble_epochs(dev, scfg, k, s_splits, {}, profile=True)
    log(ensemble_line("simple", k, got, one, {}, card))
    del one, got
    torch.cuda.empty_cache()

    # bert_full at batch 8: the eval epoch's B5 launches (the fold)
    bcfg = AudioTokensConfig(**BERT, training_batch_size=B_BERT_TRAIN,
                             log_every_steps=0)
    k = ENS_K["bert"]
    b_splits = ensemble_splits(bcfg, B_BERT_TRAIN, 43)
    b5 = {"B5": flash_attention_fwd}
    one = ensemble_epochs(dev, bcfg, 1, b_splits, b5)
    del one["trainer"], one["params"]
    got = ensemble_epochs(dev, bcfg, k, b_splits, b5)
    log(ensemble_line("bert", k, got, one, b5, card))
    ens = got["trainer"]
    c = ens.corpora["validation"]
    x, ln = c.inputs[:B_BERT_TRAIN], c.lengths[:B_BERT_TRAIN]
    ens._base.eval()
    with torch.inference_mode():
        flash_attention_fwd.launches = 0
        logits = ens._forward(got["params"], x, ln, c.labels[:B_BERT_TRAIN],
                              c.valid[:B_BERT_TRAIN].float(), None)[1]
        folded = flash_attention_fwd.launches
        probs = torch.sigmoid(logits)
        err = 0.0
        flash_attention_fwd.launches = 0
        for i in range(k):
            single = get_model(bcfg, dev, torch.Generator().manual_seed(0))
            single.load_state_dict(ens.member_params(got["params"], i))
            single.eval()
            p = torch.sigmoid(single(model_inputs(x), ln))
            err = max(err, float((probs[i] - p).abs().max()))
            del single
        per_member = flash_attention_fwd.launches
    log(f"[ensemble bert] one eval batch of {B_BERT_TRAIN}: the K {k} "
        f"members' probabilities against each member's own model (B5 per "
        f"member): max abs err {err:.3e} (bf16 bound "
        f"{ATT_TOL['bfloat16']}); B5 launches folded {folded}, per member "
        f"{per_member}")
    if (got["eval_launches"][0] != one["eval_launches"][0]
            or folded * k != per_member or err > ATT_TOL["bfloat16"]):
        raise AssertionError(f"ensemble bert: eval launches "
                             f"{got['eval_launches']} vs K 1 "
                             f"{one['eval_launches']}, folded {folded}, "
                             f"per member {per_member}, err {err:.3e}")
    records[4]["launches_by_path"][f"ensemble_eval_bert_k{k}"] = \
        got["eval_launches"][0]
    del got, one, ens
    torch.cuda.empty_cache()

    # cnn on a small bf16 spec corpus: the conv's batching rule (cuDNN)
    ccfg = dataclasses.replace(cfg, **FAMILIES["cnn"], dropout=0.0,
                               device_corpus_dtype="bfloat16")
    k = ENS_K["cnn"]
    c_splits = ensemble_splits(ccfg, B_LSTM, 44, ENS_SPEC_BATCHES, B_LSTM)
    one = ensemble_epochs(dev, ccfg, 1, c_splits, {})
    got = ensemble_epochs(dev, ccfg, k, c_splits, {})
    log(ensemble_line("cnn", k, got, one, {}, card))
    del one, got, s_splits, b_splits, c_splits, splits
    torch.cuda.empty_cache()
    log(f"[ensemble] phase 14 took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")


# -- 15. multi-process and data parallel -------------------------------------

def dp_lstm_config():
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    return AudioTokensConfig(**MODEL, training_batch_size=B_LSTM,
                             dropout=0.0, save_best_checkpoint=False,
                             log_every_steps=0, num_workers=2)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over flat arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def dp_lstm_run(dev, out: Path, tag: str) -> dict:
    """Phase 15's lstm on ``dev``: DP_EPOCH_STEPS steps of a device-resident
    epoch, then DP_STREAM_STEPS steps of the streaming loop, one ``Trainer``
    (data parallel where this process is a rank of a group of 2 or more).
    -> each step's loss (a rank's share of the global mean), each epoch's
    loss, mAP, ms a step (host clock, synchronized) and B3/B4 launches, the
    gradient all-reduce's bytes and ms (ranks); the weights go to
    ``out/<tag>_weights.npy``."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.tools.bench_training import (
        _MemLoader, synthetic_corpus)
    from audio_tokens_tpu_torch.train.device_epoch import DeviceEpochRunner
    from audio_tokens_tpu_torch.train.trainer import Trainer

    cfg = dp_lstm_config()
    trainer = Trainer(cfg, dev)
    rng = np.random.default_rng(DP_SEED)
    n = DP_EPOCH_STEPS * B_LSTM
    runner = DeviceEpochRunner(trainer)
    runner.set_corpus_arrays("train", *synthetic_corpus(cfg, B_LSTM, n, rng),
                             n, B_LSTM)
    batches = []
    for _ in range(DP_STREAM_STEPS):
        x, ln, y = synthetic_corpus(cfg, B_LSTM, B_LSTM, rng)
        batches.append({"inputs": x.astype(np.int32), "lengths": ln,
                        "labels": y.astype(np.float32), "n_valid": B_LSTM})
    losses = []
    step_fn = trainer._train_step

    def recorded(*args):
        got = step_fn(*args)
        losses.append(got[0])
        return got

    trainer._train_step = recorded
    kernels = (lstm_sequence_fwd, lstm_sequence_bwd)
    res, step = {}, 0
    for path, run in (
            ("epoch", lambda s: runner.train_epoch(0, s)),
            ("stream", lambda s: trainer._train_epoch(_MemLoader(batches), 1,
                                                      s))):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        after, loss, metrics = run(step)
        torch.cuda.synchronize()
        res[path] = dict(loss=loss, mAP=metrics["mAP"],
                         ms=(time.perf_counter() - t0) * 1e3 / (after - step),
                         launches=[k.launches for k in kernels])
        step = after
    res["step_losses"] = torch.stack(losses).tolist()
    np.save(out / f"{tag}_weights.npy", torch.cat(
        [v.reshape(-1).float() for v in
         trainer.model.state_dict().values()]).cpu().numpy())
    if trainer.dp is not None:
        params = [p for p in trainer.model.parameters() if p.grad is not None]
        res["allreduce_bytes"] = sum(p.grad.numel() * p.grad.element_size()
                                     for p in params)
        res["allreduce_ms"] = median_ms(
            lambda: trainer.dp.all_reduce_grads(params), DP_ALLREDUCE_REPS)
    return res


def dp_pipeline_run(dev, ws: Path) -> dict:
    """A rank's share of phase 15's pipeline on ``ws`` (phase 8's audio,
    split and centroids): the spectrogram stage, the staged tokenize stage
    with phase 8's centroids, the fused one (B1) into ``fused_tokens/``,
    the ``full`` streaming fit into ``output/full_centroids.npy`` and
    training on the staged tokens -> each stage's seconds and launches
    (B1, B2, B3, B4, sums), the validation loss and mAP."""
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.processors import (ClusterCreator,
                                                   ModelTrainer,
                                                   SpecTokenizer,
                                                   SpectrogramGenerator)

    kernels = (TokenizerKernel, vq_argmin, lstm_sequence_fwd,
               lstm_sequence_bwd, tier_sums64)
    stages = (SpectrogramGenerator, ClusterCreator, SpecTokenizer,
              ModelTrainer)
    seconds, launches = {}, {}
    restore = clock_stages(stages, kernels, seconds, launches)
    try:
        SpectrogramGenerator(stage_config(ws), dev).run()
        SpecTokenizer(stage_config(ws), dev).run()
        seconds["staged"] = seconds.pop("SpecTokenizer")
        launches["staged"] = launches.pop("SpecTokenizer")
        SpecTokenizer(dp_fused_config(ws, "fused_tokens"), dev).run()
        ClusterCreator(dp_full_config(ws, "full_centroids.npy"), dev).run()
        val_loss, val_metrics = ModelTrainer(stage_config(ws), dev).run()
    finally:
        restore()
    return dict(seconds=seconds, launches=launches, val_loss=val_loss,
                val_mAP=val_metrics["mAP"])


def dp_fused_config(ws: Path, tokens: str):
    return stage_config(ws, fused_pipeline=True,
                        dest_tokenized_path=str(ws / tokens))


def dp_full_config(ws: Path, name: str):
    return stage_config(ws, kmeans_mode="full", kmeans_streaming="always",
                        kmeans_superbatch_rows=STAGE_SUPERBATCH,
                        centroids_path=ws / "output" / name)


def dp_nccl_run(dev, out: Path) -> dict:
    """Phase 15 (b), one rank of a world of 1 over NCCL: one lstm step of
    a Trainer whose data group is that rank (the data-parallel step: the
    whole batch's denominator, the flat gradient all-reduce) against the
    plain step from the same weights; the all-reduce timed; then a
    2-step device epoch of that Trainer under ``set_sync_debug_mode(
    "error")`` but its one read of the two scalars."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.parallel import distributed
    from audio_tokens_tpu_torch.parallel.mesh import DataGroup
    from audio_tokens_tpu_torch.tools.bench_training import synthetic_corpus
    from audio_tokens_tpu_torch.train import device_epoch
    from audio_tokens_tpu_torch.train.trainer import Trainer

    cfg = dp_lstm_config()
    rng = np.random.default_rng(DP_SEED + 1)
    x, ln, y = synthetic_corpus(cfg, B_LSTM, B_LSTM, rng)
    batch = {"inputs": x.astype(np.int32), "lengths": ln,
             "labels": y.astype(np.float32), "n_valid": B_LSTM}
    plain, again, ranked = (Trainer(cfg, dev) for _ in range(3))
    ranked.dp = DataGroup()  # a world of one rank
    if distributed.backend() != "nccl":
        raise AssertionError(f"no NCCL group: {distributed.backend()}")
    kernels = (lstm_sequence_fwd, lstm_sequence_bwd)
    res = {}
    for tag, t in (("plain", plain), ("again", again), ("nccl", ranked)):
        for k in kernels:
            k.launches = 0
        *rows, denom = t._put_batch(batch)
        t.model.train()
        res[f"{tag}_loss"] = float(t._train_step(*rows, 0, denom)[0])
        res[f"{tag}_launches"] = [k.launches for k in kernels]
    flat = [torch.cat([v.reshape(-1) for v in t.model.state_dict().values()]
                      ).cpu().numpy() for t in (ranked, again, plain)]
    res["weights_rel"] = rel_err(flat[0], flat[2])
    # the plain step against itself: what run-to-run order leaves
    res["plain_again_rel"] = rel_err(flat[1], flat[2])
    params = [p for p in ranked.model.parameters() if p.grad is not None]
    res["allreduce_bytes"] = sum(p.grad.numel() * p.grad.element_size()
                                 for p in params)
    res["allreduce_ms"] = median_ms(lambda: ranked.dp.all_reduce_grads(params),
                                    DP_ALLREDUCE_REPS)
    # no host sync inside a data-parallel device epoch under NCCL
    n = 2 * B_LSTM
    runner = device_epoch.DeviceEpochRunner(ranked)
    runner.set_corpus_arrays("train", *synthetic_corpus(cfg, B_LSTM, n, rng),
                             n, B_LSTM)
    reads = []
    read = device_epoch.read_scalars

    def let_through(*values):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(len(values))
            return read(*values)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize()
    device_epoch.read_scalars = let_through
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss, metrics = runner.train_epoch(0, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        device_epoch.read_scalars = read
    res.update(epoch_reads=reads, epoch_loss=loss, epoch_mAP=metrics["mAP"])
    return res


def dp_rank_main(argv) -> int:
    """One rank of phase 15: ``chip_smoke.py --dp-rank RANK WORLD PORT DIR``
    joins the group through the ``AUDIO_TOKENS_*`` variables, runs
    ``DIR/plan.json``'s case on its card and writes ``DIR/rank<RANK>.json``.
    """
    import os
    from datetime import timedelta

    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    os.environ.update(AUDIO_TOKENS_COORDINATOR=f"localhost:{port}",
                      AUDIO_TOKENS_NUM_PROCESSES=str(world),
                      AUDIO_TOKENS_PROCESS_ID=str(rank))
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {rank} %(name)s %(message)s")
    import torch

    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 1
    exact_f32()
    distributed.maybe_initialize(
        None, timeout=timedelta(seconds=DP_GROUP_TIMEOUT_S))
    dev = distributed.local_device()
    plan = json.loads((out / "plan.json").read_text())
    res = {"backend": distributed.backend(), "device": str(dev)}
    if plan["case"] == "shared":
        res["lstm"] = dp_lstm_run(dev, out, f"rank{rank}")
        res["pipeline"] = dp_pipeline_run(dev, Path(plan["ws"]))
    elif plan["case"] == "mp16":
        torch.save(mp_rank(dev), out / f"rank{rank}.pt")
    elif plan["case"] == "c9det":
        torch.save(c9_deterministic(dev), out / f"rank{rank}.pt")
    else:
        res["nccl"] = dp_nccl_run(dev, out)
    distributed.barrier(plan["case"])
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def run_ranks(out: Path, world: int, plan: dict, env=None) -> list:
    """``world`` ranks of this script (``dp_rank_main``) on ``plan``, their
    output to ``out/rank<r>.log`` (``env``: more environment variables);
    every rank is killed past DP_WAIT_S and any rank's failure fails the
    phase -> their results, rank by rank."""
    import os
    import socket

    out.mkdir(parents=True, exist_ok=True)
    (out / "plan.json").write_text(json.dumps(plan))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        with open(out / f"rank{r}.log", "w") as log_f:  # Popen dups the fd
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                 str(r), str(world), str(port), str(out)],
                cwd=Path(__file__).resolve().parent, stdout=log_f,
                stderr=subprocess.STDOUT,
                env=None if env is None else {**os.environ, **env}))
    deadline = time.monotonic() + DP_WAIT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out / f"rank{r}.log").read_text()[-4000:]
            raise AssertionError(f"{plan['case']} rank {r} of {world} "
                                 f"exited {p.returncode}:\n{tail}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def dp_lstm_check(records, dev, out: Path, ranks: list, card: str) -> None:
    """(a)'s lstm against one process on the same card."""
    one = dp_lstm_run(dev, out, "single")
    got = [r["lstm"] for r in ranks]
    weights = [np.load(out / f"rank{r}_weights.npy")
               for r in range(DP_WORLD)]
    single_w = np.load(out / "single_weights.npy")
    if not all(np.array_equal(w, weights[0]) for w in weights):
        raise AssertionError("the ranks' weights differ")
    for path in ("epoch", "stream"):
        if len({(g[path]["loss"], g[path]["mAP"]) for g in got}) != 1:
            raise AssertionError(f"the ranks' {path} loss/mAP differ: "
                                 f"{[g[path] for g in got]}")
    steps = np.sum([g["step_losses"] for g in got], axis=0)
    loss_err = float(np.max(np.abs(steps - one["step_losses"])
                            / np.abs(one["step_losses"])))
    w_err = rel_err(weights[0], single_w)
    map_err = max(abs(got[0][p]["mAP"] - one[p]["mAP"])
                  for p in ("epoch", "stream"))
    launches = {p: [g[p]["launches"] for g in got] for p in ("epoch",
                                                             "stream")}
    for r in range(DP_WORLD):
        for p in ("epoch", "stream"):
            records[2]["launches_by_path"][f"dp_lstm_{p}_r{r}"] = \
                launches[p][r][0]
            records[3]["launches_by_path"][f"dp_lstm_{p}_r{r}"] = \
                launches[p][r][1]
    log(f"[dp lstm 2 ranks shared card] lstm {MODEL['lstm_embed_dim']}/"
        f"{MODEL['lstm_hidden_dim']}, T {T_LSTM}, global batch {B_LSTM} "
        f"({B_LSTM // DP_WORLD} a rank), gloo on one card, dropout 0: "
        f"{DP_EPOCH_STEPS} device-epoch + {DP_STREAM_STEPS} streaming "
        f"steps; ms a step (two ranks on one card, not a speed figure; host "
        f"clock, the epoch's first step included) epoch "
        f"{[round(g['epoch']['ms'], 2) for g in got]}, stream "
        f"{[round(g['stream']['ms'], 2) for g in got]}, one process "
        f"{one['epoch']['ms']:.2f} / {one['stream']['ms']:.2f}; gradient "
        f"all-reduce a step {got[0]['allreduce_bytes']} bytes, "
        f"{[round(g['allreduce_ms'], 3) for g in got]} ms (median of "
        f"{DP_ALLREDUCE_REPS}, through the host); against one process: "
        f"step losses {loss_err:.3e}, weights {w_err:.3e} relative (bound "
        f"{DP_RTOL}), mAP {map_err:.3e} (bound {DP_MAP_ATOL}); the ranks "
        f"equal; launches B3/B4 per rank {launches}, one process "
        f"{one['epoch']['launches']} / {one['stream']['launches']}; {card}")
    want = [[one[p]["launches"]] * DP_WORLD for p in ("epoch", "stream")]
    if (not loss_err <= DP_RTOL or not w_err <= DP_RTOL
            or not map_err <= DP_MAP_ATOL
            or [launches["epoch"], launches["stream"]] != want
            or min(one["epoch"]["launches"]) < 1):
        raise AssertionError(f"dp lstm: step losses {loss_err}, weights "
                             f"{w_err}, mAP {map_err}, launches {launches} "
                             f"(want {want})")


def same_files(a: Path, b: Path, split: dict) -> int:
    """Every clip's ``.npy`` of ``split`` under ``a`` bit-equal to ``b``'s
    (the same set of files) -> the count compared."""
    n = 0
    for name in split:
        got = sorted(p.name for p in (a / name).glob("*.npy"))
        ref = sorted(p.name for p in (b / name).glob("*.npy"))
        if got != ref or not got:
            raise AssertionError(f"{a / name}: {len(got)} files, {b / name}: "
                                 f"{len(ref)}")
        for f in got:
            x, y = np.load(a / name / f), np.load(b / name / f)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{a / name / f} differs from "
                                     f"{b / name / f}")
            n += 1
    return n


def dp_pipeline_check(records, dev, pipe: Path, ws: Path, ranks: list,
                      card: str) -> None:
    """(a)'s pipeline: the ranks' spectrograms and tokens against phase 8's
    files, their fused tokens and full fit against one process's on the
    same card, their training against one process's."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.processors import (ClusterCreator,
                                                   ModelTrainer,
                                                   SpecTokenizer)

    split = json.loads((pipe / "output" / "bal_train_data_split.json")
                       .read_text())
    got = [r["pipeline"] for r in ranks]
    n_spec = same_files(ws / "spectrograms", pipe / "spectrograms", split)
    n_tok = same_files(ws / "tokenized_audio", pipe / "tokenized_audio",
                       split)
    t0 = time.perf_counter()
    SpecTokenizer(dp_fused_config(ws, "fused_single"), dev).run()
    fused_s = time.perf_counter() - t0
    n_fused = same_files(ws / "fused_tokens", ws / "fused_single", split)
    vq_argmin.launches = tier_sums64.launches = 0
    t0 = time.perf_counter()
    ClusterCreator(dp_full_config(ws, "single_centroids.npy"), dev).run()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    one_launches = [vq_argmin.launches, tier_sums64.launches]
    cents = np.load(ws / "output" / "full_centroids.npy")
    one = np.load(ws / "output" / "single_centroids.npy")
    apart = int((cents != one).sum())
    ulps = int(np.max(np.abs(cents.view(np.int32).astype(np.int64)
                             - one.view(np.int32).astype(np.int64))))
    one_val = ModelTrainer(stage_config(
        ws, checkpoint_dir=str(ws / "single_checkpoints")), dev).run()
    val_err = abs(got[0]["val_loss"] - one_val[0]) / abs(one_val[0])
    map_err = abs(got[0]["val_mAP"] - one_val[1]["mAP"])
    names = ("B1", "B2", "B3", "B4", "sums")
    for r, g in enumerate(got):
        lc = g["launches"]
        records[0]["launches_by_path"][f"dp_fused_tokenize_r{r}"] = \
            lc["SpecTokenizer"][0]
        records[1]["launches_by_path"].update({
            f"dp_tokenize_r{r}": lc["staged"][1],
            f"dp_cluster_r{r}": lc["ClusterCreator"][1]})
        sums_record(records)["launches_by_path"][f"dp_cluster_r{r}"] = \
            lc["ClusterCreator"][4]
        records[2]["launches_by_path"][f"dp_train_r{r}"] = \
            lc["ModelTrainer"][2]
        records[3]["launches_by_path"][f"dp_train_r{r}"] = \
            lc["ModelTrainer"][3]
    stage_names = ("SpectrogramGenerator", "staged", "SpecTokenizer",
                   "ClusterCreator", "ModelTrainer")
    log(f"[dp pipeline 2 ranks] phase 8's audio, clips sharded over 2 ranks "
        f"on one card (gloo): seconds a stage a rank "
        + "; ".join(f"{n} {[round(g['seconds'][n], 2) for g in got]}"
                    for n in stage_names)
        + f" (SpecTokenizer: fused, B1; staged: phase 8's centroids, B2); "
        f"launches {'/'.join(names)} a stage a rank "
        + "; ".join(f"{n} {[g['launches'][n] for g in got]}"
                    for n in stage_names)
        + f"; spectrograms {n_spec} and tokens {n_tok} files bit-equal to "
        f"phase 8's; fused tokens {n_fused} files bit-equal to one process's "
        f"({fused_s:.2f} s); training val loss {got[0]['val_loss']:.6f} "
        f"({val_err:.3e} from one process, bound {DP_RTOL}), mAP "
        f"{got[0]['val_mAP']:.6f} ({map_err:.3e}, bound {DP_MAP_ATOL}); "
        f"{card}")
    log(f"[dp kmeans 2 ranks] kmeans_mode=full streaming, "
        f"{STAGE_SUPERBATCH}-row super-batches, each rank its shard of the "
        f"files, f64 sums all-reduced once an iteration: "
        f"{[round(g['seconds']['ClusterCreator'], 2) for g in got]} s a "
        f"rank, one process {full_s:.2f} s; B2/sums launches a rank "
        f"{[[g['launches']['ClusterCreator'][i] for i in (1, 4)] for g in got]}"
        f", one process {one_launches}; centroids against one process's "
        f"full fit: {apart} of {one.size} values apart, at most {ulps} ulp "
        f"(bound 1); {card}")
    if (len({(g["val_loss"], g["val_mAP"]) for g in got}) != 1
            or not val_err <= DP_RTOL or not map_err <= DP_MAP_ATOL
            or ulps > 1):
        raise AssertionError(f"dp pipeline: val {[g['val_loss'] for g in got]}"
                             f" vs {one_val}, centroids {ulps} ulp apart")
    for g in got:
        lc = g["launches"]
        if (lc["SpecTokenizer"][0] < 1 or lc["staged"][1] < 1
                or lc["ClusterCreator"][1] < 1 or lc["ClusterCreator"][4] < 1
                or min(lc["ModelTrainer"][2:4]) < 1):
            raise AssertionError(f"dp pipeline: a kernel did not launch: "
                                 f"{lc}")


def dp_nccl_check(records, out: Path, card: str) -> None:
    """(b): one NCCL rank's data-parallel step against the plain step."""
    got = run_ranks(out, 1, {"case": "nccl"})[0]
    res = got["nccl"]
    loss_rel = abs(res["nccl_loss"] - res["plain_loss"]) / abs(
        res["plain_loss"])
    records[2]["launches_by_path"]["dp_nccl_step"] = res["nccl_launches"][0]
    records[3]["launches_by_path"]["dp_nccl_step"] = res["nccl_launches"][1]
    log(f"[dp nccl 1 rank] backend {got['backend']} on {got['device']}: one "
        f"lstm step through the data-parallel path (the whole batch's "
        f"denominator, the flat all-reduce) against the plain step: loss "
        f"{loss_rel:.3e}, weights {res['weights_rel']:.3e} relative (bound "
        f"{DP_NCCL_RTOL}; the plain step run twice: "
        f"{res['plain_again_rel']:.3e}); all-reduce {res['allreduce_bytes']} bytes, "
        f"{res['allreduce_ms']:.3f} ms (median of {DP_ALLREDUCE_REPS}); "
        f"launches B3/B4 {res['nccl_launches']} (plain "
        f"{res['plain_launches']}); a 2-step device epoch under "
        f"set_sync_debug_mode('error') read {res['epoch_reads']} scalars, "
        f"loss {res['epoch_loss']:.6f}; {card}")
    if (got["backend"] != "nccl" or not loss_rel <= DP_NCCL_RTOL
            or not res["weights_rel"] <= DP_NCCL_RTOL
            or res["nccl_launches"] != res["plain_launches"]
            or res["epoch_reads"] != [2]
            or not np.isfinite(res["epoch_loss"])):
        raise AssertionError(f"dp nccl: {got}")


def dp_phase(records: list, dev, pipe: Path) -> None:
    """Phase 15: multi-process and data parallel (see the module's
    docstring) on phase 8's workspace ``pipe``."""
    import shutil

    card = card_line()
    ws = shared_workspace(pipe, "dp")
    shutil.copy(pipe / "output" / "centroids.npy",
                ws / "output" / "centroids.npy")
    out = ws / "ranks"
    t0 = time.perf_counter()
    ranks = run_ranks(out, DP_WORLD, {"case": "shared", "ws": str(ws)})
    ranks_s = time.perf_counter() - t0
    if [r["backend"] for r in ranks] != ["gloo"] * DP_WORLD:
        raise AssertionError(f"ranks sharing one card: {ranks}")
    log(f"[dp ranks] {DP_WORLD} ranks of this script sharing "
        f"{ranks[0]['device']} over gloo: {ranks_s:.1f} s from start to "
        "exit (process start, kernels loaded, lstm, pipeline)")
    dp_lstm_check(records, dev, out, ranks, card)
    dp_pipeline_check(records, dev, pipe, ws, ranks, card)
    dp_nccl_check(records, ws / "nccl", card)



# -- 16. tensor and sequence parallelism, the batch-split entry points --------

def mp_bert_config(dtype: str, **over):
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    return AudioTokensConfig(**{
        **BERT, "compute_dtype": dtype, "training_batch_size": MP_BATCH,
        "reference_compat": False, "save_best_checkpoint": False,
        "log_every_steps": 0, **over})


def mp_bert_batch(cfg) -> dict:
    """The phase's bert batch: tools/bench_training's synthetic tokens,
    random lengths with a 0."""
    from audio_tokens_tpu_torch.tools.bench_training import synthetic_corpus

    rng = np.random.default_rng(MP_SEED)
    x, _, y = synthetic_corpus(cfg, MP_BATCH, MP_BATCH, rng)
    lengths = rng.integers(1, cfg.max_seq_len + 1, MP_BATCH).astype(np.int32)
    lengths[0] = 0
    return {"inputs": x.astype(np.int32), "lengths": lengths,
            "labels": y.astype(np.float32), "n_valid": MP_BATCH}


def mp_bert_run(dev, dtype: str, train: bool, **over) -> dict:
    """One bert ``Trainer`` (``over``: model_parallel or sequence_parallel,
    or none: one process) on the phase's batch: an eval pass (B5's
    forward), then with ``train`` one training step (the plain attention
    route) -> the logits, the step's loss, the gradients and the weights
    after it (one process's layout, joined over the model ranks), B5's
    launches and the ms of each (host clock, synchronized)."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd
    from audio_tokens_tpu_torch.parallel.mesh import tp_gather
    from audio_tokens_tpu_torch.train.trainer import Trainer

    t = Trainer(mp_bert_config(dtype, **over), dev)
    *rows, denom = t._put_batch(mp_bert_batch(t.config))
    t.model.eval()
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = t._logits(rows[0], rows[1])
    torch.cuda.synchronize()
    res = dict(eval_ms=(time.perf_counter() - t0) * 1e3,
               eval_launches=flash_attention_fwd.launches,
               logits=logits.float().cpu())
    if not train:
        return res
    full = (t.model.state_dict if t.mesh is None
            else t.model.full_state_dict)
    before = {n: w.detach().clone() for n, w in full().items()}
    t.model.train()
    t0 = time.perf_counter()
    loss = float(t._train_step(*rows, 0, denom)[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    grads = {n: p.grad for n, p in t.model.named_parameters()}
    if t.mesh is not None:
        grads = tp_gather(t.mesh, grads, t.model.tp_specs)
    weights = full()
    res.update(step_ms=step_ms, loss=loss,
               grads={n: g.float().cpu() for n, g in grads.items()},
               weights={n: w.float().cpu() for n, w in weights.items()},
               moved={n: float((w.float() - before[n].float()).abs().max())
                      for n, w in weights.items()},
               lr=t.config.learning_rate)
    return res


def mp_flash_grad(dev, dtype: str, **over) -> dict:
    """An eval-mode loss + backward of the bert on the B5 route (``over``:
    sequence_parallel, or none: one process) on the phase's batch: B5's
    forward and backward pair, on a sequence rank its query block against
    the gathered keys -> the loss, the gradients summed over the mesh's
    replica group and joined (one process's layout), B5's launches
    (forward, dk/dv, dq) and the ms (host clock, synchronized)."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from audio_tokens_tpu_torch.parallel.mesh import tp_gather
    from audio_tokens_tpu_torch.train.objective import weighted_bce
    from audio_tokens_tpu_torch.train.trainer import Trainer

    t = Trainer(mp_bert_config(dtype, **over), dev)
    inputs, lengths, labels, row_w, denom = t._put_batch(
        mp_bert_batch(t.config))
    t.model.eval()
    kernels = (flash_attention_fwd, flash_attention_bwd_dkv,
               flash_attention_bwd_dq)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    t.model.zero_grad(set_to_none=True)
    loss = weighted_bce(t._logits(inputs, lengths), labels, row_w, denom)
    loss.backward()
    if t.grad_group is not None:
        t.grad_group.all_reduce_grads(t.model.parameters())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = [k.launches for k in kernels]
    grads = {n: p.grad for n, p in t.model.named_parameters()}
    if t.mesh is not None:
        grads = tp_gather(t.mesh, grads, t.model.tp_specs)
    return dict(loss=float(loss.detach()), ms=ms, launches=launches,
                grads={n: g.float().cpu() for n, g in grads.items()})


def mp_flash_grad_check(records: list, dev, got: list, floor: float,
                        card: str, launches: dict, bwd_launches: dict
                        ) -> None:
    """The eval-mode B5-route gradient on SP 2 (``got``, the ranks'
    results) against one process on the card: f32 within MP_WEIGHT_RTOL
    or C9's floor (the larger; max |a - b| / max |b| over every gradient)
    and the loss within MP_LOSS_RTOL; bf16 printed, not bound (each block's
    dk and dv are rounded to 8 bits before the gather's backward sums
    them).  Every rank must launch B5's forward, dk/dv and dq.  The ranks'
    launches go to ``launches`` (the query-block forward's records) and
    ``bwd_launches`` (its backward pair's), one process's to the full
    window's records (B5's forward, dk/dv and dq: records 5, 8, 9 in f32,
    4, 6, 7 in bf16)."""
    for dtype, tag, full in (("float32", "f32", (5, 8, 9)),
                             ("bfloat16", "bf16", (4, 6, 7))):
        one = mp_flash_grad(dev, dtype)
        case = f"sp_flash_grad_{tag}"
        mine = got[0][case]
        names = sorted(one["grads"])
        if sorted(mine["grads"]) != names:
            raise AssertionError(f"phase 16 {case}: parameters "
                                 f"{sorted(mine['grads'])} vs {names}")
        apart = rel_err(torch_cat(mine["grads"][n] for n in names),
                        torch_cat(one["grads"][n] for n in names))
        worst = max(names, key=lambda n: rel_err(
            mine["grads"][n].numpy(), one["grads"][n].numpy()))
        loss_err = abs(mine["loss"] - one["loss"]) / abs(one["loss"])
        finite = all(bool(np.isfinite(g.numpy()).all())
                     for g in mine["grads"].values())
        bound = max(floor, MP_WEIGHT_RTOL)
        ranks = [g[case]["launches"] for g in got]
        for r, (fwd, dkv, dq) in enumerate(ranks):
            launches[dtype][f"mp_sp_eval_grad_r{r}"] = fwd
            bwd_launches[dtype]["dkv"][f"mp_sp_eval_grad_r{r}"] = dkv
            bwd_launches[dtype]["dq"][f"mp_sp_eval_grad_r{r}"] = dq
        log(f"[mp sp flash grad {MP_WORLD} ranks {dtype}] eval-mode loss + "
            f"backward of bert hidden {BERT['hidden_size']} x "
            f"{BERT['num_layers']} layers on the B5 route, window "
            f"{BERT['max_seq_len']} ({BERT['max_seq_len'] // MP_WORLD} query "
            f"rows a rank against the gathered keys), batch {MP_BATCH}, "
            f"random lengths with a 0: loss {mine['loss']:.7f} vs one "
            f"process {one['loss']:.7f} ({loss_err:.3e} relative), the "
            f"gradients summed over the ranks {apart:.3e} (max |a - b| / max "
            f"|b|, worst {worst}) from one process's"
            + (f" (bound {bound:.3e}: {MP_WEIGHT_RTOL}, or C9's floor "
               f"{floor:.3e}; loss {MP_LOSS_RTOL})" if tag == "f32" else
               " (bf16: each block's dk, dv rounded to 8 bits before the "
               "sum; not bound)")
            + f"; B5 forward, dk/dv, dq launches per rank {ranks} (one "
            f"process {one['launches']}); ms "
            f"{[round(g[case]['ms'], 1) for g in got]}, one process "
            f"{one['ms']:.1f}; {card}")
        if not finite or min(min(x) for x in ranks) < 1 or min(
                one["launches"]) < 1:
            raise AssertionError(f"phase 16 {case}: finite {finite}, "
                                 f"launches {ranks}, {one['launches']}")
        if tag == "f32" and not (apart <= bound and loss_err <= MP_LOSS_RTOL):
            raise AssertionError(f"phase 16 {case}: gradients {apart:.3e} "
                                 f"(bound {bound:.3e}), loss {loss_err:.3e}")
        for i, n in zip(full, one["launches"]):
            records[i]["launches_by_path"]["mp_one_eval_grad"] = n


def mp_serve(dev, mesh) -> dict:
    """The batch-split entry points on ``mesh`` (None: ``serve`` and
    ``tokens_from_padded`` in one process): the lstm and bert (f32, B5)
    programs and the tokenizer on MP_SERVE_CLIPS ten-second clips ->
    their outputs and B1/B3/B5 launches."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd
    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence_fwd
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    kernels = (TokenizerKernel, lstm_sequence_fwd, flash_attention_fwd)
    cents = make_centroids()
    cfgs = {"lstm": AudioTokensConfig(clip_seconds=CLIP_SECONDS, **MODEL),
            "bert": AudioTokensConfig(clip_seconds=CLIP_SECONDS, **{
                **BERT, "compute_dtype": "float32"})}
    tok = FusedTokenizer(cfgs["lstm"], cents, dev)
    batch, lengths = tok.frontend.prepare_batch(make_clips(MP_SERVE_CLIPS))
    x, ln = torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev)
    res = {}

    def counted(tag, fn):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        res[f"{tag}_launches"] = [k.launches for k in kernels]
        return out

    res["tokens"] = counted("tokens", lambda: (
        tok.tokens_from_padded(x) if mesh is None
        else tok.tokens_sharded(x, mesh))).cpu()
    for name, cfg in cfgs.items():
        prog = ServingProgram.from_components(
            cfg, FusedTokenizer(cfg, cents, dev), device=dev,
            generator=torch.Generator().manual_seed(MP_SEED))
        out = counted(name, lambda: (prog.serve(x, ln) if mesh is None
                                     else prog.serve_sharded(x, ln, mesh)))
        res[name] = [t.cpu() for t in out]
    return res


def mp_ensemble(dev, mesh, seeds=None) -> dict:
    """The full-width lstm ensemble, K 2 (over ``mesh``'s ranks, or in one
    process; ``seeds``: those members in one process): a training epoch and
    the eval epoch -> their numbers and B3/B4 launches."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = AudioTokensConfig(**MODEL, training_batch_size=B_LSTM,
                            dropout=0.1, save_best_checkpoint=False)
    ens = EnsembleTrainer(cfg, dev, n_models=2, seeds=seeds, mesh=mesh)
    for split, arrays in ensemble_splits(cfg, B_LSTM, MP_SEED,
                                         MP_ENS_BATCHES, MP_ENS_VAL).items():
        ens.set_corpus_arrays(split, *arrays, B_LSTM)
    params, opt_state = ens.init_state()
    kernels = (lstm_sequence_fwd, lstm_sequence_bwd)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    _, _, _, loss, per, ens_map = ens.train_epoch(params, opt_state, 0, 0)
    v_loss, v_per, v_ens = ens.eval_epoch(params)
    return dict(loss=loss, per=per, ens=ens_map, v_loss=v_loss, v_per=v_per,
                v_ens=v_ens, launches=[k.launches for k in kernels],
                local=ens.n_local, seeds=ens.seeds,
                ms=(time.perf_counter() - t0) * 1e3)


def ens_apart(a: dict, b: dict, members=slice(None)) -> tuple:
    """Two ensemble runs' (losses relative, mAP absolute) apart: per member
    (``members`` of ``b``'s), and the ensemble's mAP where both have all
    the members."""
    losses = max(float(np.max(np.abs(np.asarray(a[key])
                                     - np.asarray(b[key])[members])
                              / np.abs(np.asarray(b[key])[members])))
                 for key in ("loss", "v_loss"))
    maps = max(float(np.max(np.abs(np.asarray(a[key])
                                   - np.asarray(b[key])[members])))
               for key in ("per", "v_per"))
    if members == slice(None):
        maps = max(maps, abs(a["ens"] - b["ens"]), abs(a["v_ens"] - b["v_ens"]))
    return losses, maps


def mp_report(dev, **over):
    """The gradient-flow report of the f32 bert ``Trainer`` (``over``:
    model_parallel or sequence_parallel, or none: one process) on the
    phase's batch -> (the report, or None on a rank other than 0; ms, host
    clock, synchronized)."""
    import torch

    from audio_tokens_tpu_torch.train.trainer import Trainer

    t = Trainer(mp_bert_config("float32", **over), dev)
    batch = mp_bert_batch(t.config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = t.gradient_report(batch)
    torch.cuda.synchronize()
    return report, (time.perf_counter() - t0) * 1e3


def report_gap(got: dict, ref: dict) -> dict:
    """The largest relative gap of each statistic of ``got`` from
    ``ref`` over the parameters, and where it sits."""
    out = {}
    for key in ("mean_abs_grad", "max_abs_grad"):
        gaps = {n: abs(got[n][key] - r[key]) / max(abs(r[key]),
                                                   MP_REPORT_FLOOR)
                for n, r in ref.items()}
        worst = max(gaps, key=gaps.get)
        out[key] = (gaps[worst], worst)
    return out


def mp_rank(dev) -> dict:
    """A rank of phase 16 (``dp_rank_main``'s ``mp16`` case)."""
    from audio_tokens_tpu_torch.parallel import distributed
    from audio_tokens_tpu_torch.parallel.mesh import DataGroup, make_mesh

    res = {"tp_f32": mp_bert_run(dev, "float32", True, model_parallel=2),
           "sp_f32": mp_bert_run(dev, "float32", True, sequence_parallel=2),
           "sp_bf16": mp_bert_run(dev, "bfloat16", False,
                                  sequence_parallel=2),
           "sp_flash_grad_f32": mp_flash_grad(dev, "float32",
                                              sequence_parallel=2),
           "sp_flash_grad_bf16": mp_flash_grad(dev, "bfloat16",
                                               sequence_parallel=2),
           "serve": mp_serve(dev, make_mesh()),
           "ensemble": mp_ensemble(dev, DataGroup()),
           "tp_report": mp_report(dev, model_parallel=2),
           "sp_report": mp_report(dev, sequence_parallel=2)}
    if not distributed.is_coordinator():  # the joined tensors: rank 0's
        for case in ("tp_f32", "sp_f32"):
            del res[case]["grads"], res[case]["weights"]
        for case in ("sp_flash_grad_f32", "sp_flash_grad_bf16"):
            del res[case]["grads"]
    return res


def c9_steps(dev, cfg, batch) -> dict:
    """C9: two one-process ``Trainer``s of ``cfg`` -> their weights apart
    before a step on ``batch``, the first parameter whose gradient differs
    after it (max |a - b| / max |b|) and the worst, the weights apart after
    it (max |a - b| / max |b| over all)."""
    from audio_tokens_tpu_torch.train.trainer import Trainer

    pair = [Trainer(cfg, dev) for _ in range(2)]
    flat = lambda t: torch_cat(t.model.state_dict().values())
    before = rel_err(flat(pair[0]), flat(pair[1]))
    for t in pair:
        *rows, denom = t._put_batch(batch)
        t.model.train()
        t._train_step(*rows, 0, denom)
    first, worst = None, ("", 0.0)
    params = [dict(t.model.named_parameters()) for t in pair]
    for name, p in params[1].items():
        a, b = params[0][name].grad, p.grad
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if err > 0 and first is None:
            first = (name, err)
        if err > worst[1]:
            worst = (name, err)
    return dict(before=before, first=first, worst=worst,
                after=rel_err(flat(pair[0]), flat(pair[1])))


def torch_cat(tensors) -> np.ndarray:
    import torch

    return torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()


def c9_cases(dev) -> dict:
    """C9's two steps for phase 15's lstm and phase 16's f32 bert."""
    from audio_tokens_tpu_torch.tools.bench_training import synthetic_corpus

    lstm = dp_lstm_config()
    x, ln, y = synthetic_corpus(lstm, B_LSTM, B_LSTM,
                                np.random.default_rng(DP_SEED + 1))
    bert = mp_bert_config("float32")
    return {"lstm": c9_steps(dev, lstm, {
                "inputs": x.astype(np.int32), "lengths": ln,
                "labels": y.astype(np.float32), "n_valid": B_LSTM}),
            "bert": c9_steps(dev, bert, mp_bert_batch(bert))}


def c9_deterministic(dev) -> dict:
    """C9 under ``torch.use_deterministic_algorithms(True, warn_only=
    True)``, in a process started with ``CUBLAS_WORKSPACE_CONFIG``; the
    warnings of ops without a deterministic implementation kept."""
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        res = c9_cases(dev)
    res["warnings"] = sorted({str(w.message).split("\n")[0][:160]
                              for w in seen})
    return res


def c9_line(mode: str, res: dict, card: str) -> str:
    parts = []
    for model in ("lstm", "bert"):
        r = res[model]
        first = ("none" if r["first"] is None
                 else f"{r['first'][0]} {r['first'][1]:.3e}")
        parts.append(
            f"{model}: weights before the step {r['before']:.3e}, first "
            f"gradient apart {first}, worst {r['worst'][0]} "
            f"{r['worst'][1]:.3e}, weights after {r['after']:.3e}")
    return f"[c9 {mode}] two one-process Trainers, one step each; " + \
        "; ".join(parts) + f" (max |a - b| / max |b|); {card}"


def mp_compare(tag: str, got: dict, one: dict, floor: float, card: str
               ) -> dict:
    """A rank-0 case of (a)/(b) against one process: logits, loss, each
    gradient (elementwise, JAX's rtol/atol), the weights after the step
    (relative, MP_WEIGHT_RTOL or C9's floor, the larger) and the step
    itself: every tensor that one process's AdamW step moved by half an lr
    or more moved so on the ranks too, so a step that left the sharded
    weights where they were fails."""
    err = {"logits": float((got["logits"] - one["logits"]).abs().max())}
    if "loss" in got:
        err["loss"] = abs(got["loss"] - one["loss"]) / abs(one["loss"])
        excess, name = 0.0, ""
        for n, g in got["grads"].items():
            ref = one["grads"][n]
            e = float(((g - ref).abs() / (MP_GRAD_TOL["atol"]
                                          + MP_GRAD_TOL["rtol"] * ref.abs())
                       ).max())
            if e > excess:
                excess, name = e, n
        err["grad_excess"], err["grad_worst"] = excess, name
        w_got = torch_cat(got["weights"][n] for n in one["weights"])
        w_one = torch_cat(one["weights"].values())
        err["weights"] = rel_err(w_got, w_one)
        err["weights_bound"] = max(floor, MP_WEIGHT_RTOL)
        half = 0.5 * one["lr"]
        moved = [n for n, m in one["moved"].items() if m >= half]
        err["moved"] = len(moved)
        err["unmoved"] = [n for n in moved if not got["moved"][n] >= half]
        err["step_lr"] = min(got["moved"][n] for n in moved) / one["lr"]
    return err


def b5_query_block(records: list, launches: dict) -> None:
    """B5's forward on a query block (rows MP_T_Q.. of the window against
    all of it; prefix lengths with a 0) in bf16 and f32: against its plain
    version and against those rows of the full-window B5 output, timed
    beside ``scaled_dot_product_attention`` with the boolean segment mask;
    the bound from the work these lengths need.  Appends the two records,
    with ``launches`` (each dtype's phase-16 path counts)."""
    import torch
    import torch.nn.functional as F

    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_fwd, flash_attention_plain)

    card = card_line()
    for name, dtype, kind in (("bfloat16", torch.bfloat16, "bf16"),
                              ("float32", torch.float32, "f32, 3xTF32")):
        q, k, v, _, seg, _, _ = attention_inputs(BATCH, dtype, 7)
        lo = MP_T_Q
        qb, seg_q = q[:, :, lo:].contiguous(), seg[:, lo:].contiguous()
        got = flash_attention_fwd(qb, k, v, seg_q, SM_SCALE,
                                  kv_segment_ids=seg)[0]
        ref = flash_attention_plain(qb, k, v, seg_q, SM_SCALE,
                                    kv_segment_ids=seg)
        full = flash_attention_fwd(q, k, v, seg, SM_SCALE)[0][:, :, lo:]
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rows_err = float((got.float() - full.float()).abs().max())
        del ref, full
        if not max(err, rows_err) <= ATT_TOL[name]:
            raise AssertionError(f"B5 query block {name}: {err:.3e} vs its "
                                 f"plain version, {rows_err:.3e} vs the "
                                 f"full window's rows > {ATT_TOL[name]}")
        ms = cuda_ms(lambda: flash_attention_fwd(
            qb, k, v, seg_q, SM_SCALE, kv_segment_ids=seg), 5)
        full_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, seg,
                                                      SM_SCALE), 5)
        plain_ms = cuda_ms(lambda: flash_attention_plain(
            qb, k, v, seg_q, SM_SCALE, kv_segment_ids=seg), 2)
        mask = seg_q[:, None, :, None] == seg[:, None, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, k, v, attn_mask=mask, scale=SM_SCALE), 5)
        # the work these lengths need: each query row against its segment
        same = (seg_q[:, :, None] == seg[:, None, :]).sum()
        pairs = int(same) * HEADS
        flop = 4 * HEAD_DIM * pairs
        el = q.element_size()
        nbytes = (2 * qb.numel() + 2 * k.numel()) * el + (
            seg_q.numel() + seg.numel()) * 4
        peak = "tf32x3" if name == "float32" else name
        b_ms, b_by = bound_of(flop, nbytes, peak)
        log(f"[B5 query block] {name} q {tuple(qb.shape)} (rows {lo}..) "
            f"against k, v {tuple(k.shape)}, prefix lengths with a 0: max "
            f"abs err {err:.3e} vs its plain version, {rows_err:.3e} vs "
            f"those rows of the full window's B5 (atol {ATT_TOL[name]}); "
            f"kernel {ms:.3f} ms ({ms / full_ms:.3f} of the full window's "
            f"{full_ms:.3f} ms), plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention {lib_ms:.3f} ms; bound "
            f"{b_ms:.3f} ms ({b_by}, {b_ms / ms:.0%}); "
            f"{flop / ms / 1e9:.1f} TFLOP/s of {flop / 1e9:.1f} GFLOP; "
            f"{card}")
        records.append(dict(
            name=f"B5 flash attention forward, query block against the "
                 f"gathered keys ({kind})", route="cuda",
            source="audio_tokens_tpu_torch/csrc/attention.cu",
            replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:331 "
                     "(SegmentIds(q=, kv=); called at audio_tokens_tpu/"
                     "models/transformer.py:133)",
            max_abs_err=max(err, rows_err), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            full_window_ms=full_ms, launches_by_path=launches[name]))
        del q, k, v, qb, seg, seg_q, got, mask
        torch.cuda.empty_cache()


def b5_query_block_bwd(records: list, launches: dict) -> None:
    """B5's backward pair on the two query blocks of the window (rows
    ..MP_T_Q and MP_T_Q.. against every key; batch B_ATT_BWD, prefix
    lengths with a 0) in bf16 and f32, each block on its own B5 forward's
    logsumexp: the kernels against their plain versions (ATT_TOL), each
    block's dq against those rows of the full window's and the blocks' dk
    and dv summed against the full window's (ATT_BWD_RTOL of the largest
    entry); the second block (sequence rank 1's) timed beside the full
    window's kernels, the plain versions and ``scaled_dot_product_attention``'s
    backward with the boolean mask on the same views; the bounds from the
    work these lengths need.  Appends four records with ``launches`` (each
    dtype's and kernel's phase-16 path counts)."""
    import torch
    import torch.nn.functional as F

    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_plain, flash_attention_dq_plain,
        flash_attention_fwd)

    card = card_line()
    for name, dtype, kind in (("bfloat16", torch.bfloat16, "bf16"),
                              ("float32", torch.float32, "f32, 3xTF32")):
        q, k, v, do, seg, _, _ = attention_inputs(B_ATT_BWD, dtype, 8)
        t = q.shape[2]
        o, lse = flash_attention_fwd(q, k, v, seg, SM_SCALE, True)
        di = (o.float() * do.float()).sum(-1)
        full_args = (q, k, v, seg, lse, do, di, SM_SCALE)
        full = (*flash_attention_bwd_dkv(*full_args),
                flash_attention_bwd_dq(*full_args))

        def block(lo, hi):
            qb, dob = (a[:, :, lo:hi].contiguous() for a in (q, do))
            seg_q = seg[:, lo:hi].contiguous()
            ob, lseb = flash_attention_fwd(qb, k, v, seg_q, SM_SCALE, True,
                                           kv_segment_ids=seg)
            dib = (ob.float() * dob.float()).sum(-1)
            return qb, k, v, seg_q, lseb, dob, dib, SM_SCALE, seg

        grads = ("dk", "dv", "dq")
        plain_err = dict.fromkeys(grads, 0.0)
        dq_rows = 0.0
        sums = [torch.zeros(k.shape, device=k.device) for _ in range(2)]
        for lo, hi in ((0, MP_T_Q), (MP_T_Q, t)):
            args = block(lo, hi)
            got = (*flash_attention_bwd_dkv(*args),
                   flash_attention_bwd_dq(*args))
            ref = (*flash_attention_dkv_plain(*args),
                   flash_attention_dq_plain(*args))
            for g, a, b in zip(grads, got, ref):
                plain_err[g] = max(plain_err[g], float(
                    (a.float() - b.float()).abs().max()))
            dq_rows = max(dq_rows, float(
                (got[2].float() - full[2][:, :, lo:hi].float()).abs().max()))
            sums[0] += got[0].float()
            sums[1] += got[1].float()
            del got, ref
        top = {g: float(x.float().abs().max()) for g, x in zip(grads, full)}
        rel = {"dq rows": dq_rows / top["dq"],
               "dk summed": float((sums[0] - full[0].float()).abs().max())
               / top["dk"],
               "dv summed": float((sums[1] - full[1].float()).abs().max())
               / top["dv"]}
        torch.cuda.synchronize()
        del sums
        if not (max(plain_err.values()) <= ATT_TOL[name]
                and max(rel.values()) <= ATT_BWD_RTOL[name]):
            raise AssertionError(f"B5 query block backward {name}: "
                                 f"{plain_err} vs the plain versions "
                                 f"(atol {ATT_TOL[name]}), {rel} vs the "
                                 f"full window ({ATT_BWD_RTOL[name]} of the "
                                 f"largest entry)")
        args = block(MP_T_Q, t)
        qb, _, _, seg_q, lseb, dob = args[:6]
        dkv_ms = cuda_ms(lambda: flash_attention_bwd_dkv(*args), 5)
        dq_ms = cuda_ms(lambda: flash_attention_bwd_dq(*args), 5)
        full_ms = (cuda_ms(lambda: flash_attention_bwd_dkv(*full_args), 5),
                   cuda_ms(lambda: flash_attention_bwd_dq(*full_args), 5))
        dkv_plain = cuda_ms(lambda: flash_attention_dkv_plain(*args), 2)
        dq_plain = cuda_ms(lambda: flash_attention_dq_plain(*args), 2)
        leaves = [a.detach().requires_grad_() for a in (qb, k, v)]
        mask = seg_q[:, None, :, None] == seg[:, None, None, :]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=SM_SCALE)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, dob, retain_graph=True), 5)
        # the work these lengths need: each query row of the block against
        # the keys of its segment
        pairs = int((seg_q[:, :, None] == seg[:, None, :]).sum()) * HEADS
        el = q.element_size()
        rows = 2 * lseb.numel() * 4 + (seg_q.numel() + seg.numel()) * 4
        dkv_io = (2 * qb.numel() + 4 * k.numel()) * el + rows
        dq_io = (3 * qb.numel() + 2 * k.numel()) * el + rows
        peak = "tf32x3" if name == "float32" else name
        dkv_b = bound_of(8 * HEAD_DIM * pairs, dkv_io, peak)
        dq_b = bound_of(6 * HEAD_DIM * pairs, dq_io, peak)
        fma = (bound_of(8 * HEAD_DIM * pairs, dkv_io, name)[0],
               bound_of(6 * HEAD_DIM * pairs, dq_io, name)[0])
        log(f"[B5 query block backward] {name} q, do {tuple(qb.shape)} (rows "
            f"{MP_T_Q}..; and rows ..{MP_T_Q}) against k, v {tuple(k.shape)}, "
            f"prefix lengths with a 0: max abs err vs the plain versions "
            + ", ".join(f"{g} {e:.3e}" for g, e in plain_err.items())
            + f" (atol {ATT_TOL[name]}); against the full window's pair, "
            "max |a - b| / max |full| "
            + ", ".join(f"{g} {e:.3e}" for g, e in rel.items())
            + f" (bound {ATT_BWD_RTOL[name]}); dk/dv kernel {dkv_ms:.3f} ms "
            f"({dkv_ms / full_ms[0]:.3f} of the full window's "
            f"{full_ms[0]:.3f}; plain {dkv_plain:.3f}, bound {dkv_b[0]:.3f} "
            f"{dkv_b[1]}, {dkv_b[0] / dkv_ms:.0%}), dq kernel {dq_ms:.3f} ms "
            f"({dq_ms / full_ms[1]:.3f} of {full_ms[1]:.3f}; plain "
            f"{dq_plain:.3f}, bound {dq_b[0]:.3f} {dq_b[1]}, "
            f"{dq_b[0] / dq_ms:.0%}); the pair {dkv_ms + dq_ms:.3f} ms vs "
            f"scaled_dot_product_attention backward (dq, dk, dv together, "
            f"boolean mask) {lib_ms:.3f} ms; {8 * HEAD_DIM * pairs / 1e9:.1f} "
            f"/ {6 * HEAD_DIM * pairs / 1e9:.1f} GFLOP; {card}")
        for i, (key, label, line, err, ms, plain_ms, (b_ms, b_by)) in \
                enumerate((("dkv", "dk/dv", 796,
                            max(plain_err["dk"], plain_err["dv"]), dkv_ms,
                            dkv_plain, dkv_b),
                           ("dq", "dq", 1146, plain_err["dq"], dq_ms,
                            dq_plain, dq_b))):
            rec = dict(
                name=f"B5 flash attention backward {label}, query block "
                     f"against the gathered keys ({kind})", route="cuda",
                source="audio_tokens_tpu_torch/csrc/attention.cu",
                replaces=f"jax/experimental/pallas/ops/tpu/"
                         f"flash_attention.py:{line} (SegmentIds(q=, kv=) "
                         f"of two lengths)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, full_window_ms=full_ms[i],
                launches_by_path=launches[name][key])
            if name == "float32":
                rec["fma_bound_ms"] = fma[i]
            records.append(rec)
        del q, k, v, do, seg, o, lse, di, full, full_args, args, qb, dob
        del leaves, out, mask
        torch.cuda.empty_cache()


def mp_report_check(dev, got: list, card: str) -> None:
    """(e): rank 0's reports on TP 2 and SP 2 (``got``, the ranks'
    results) against one process's on the same weights and batch."""
    one_report, one_ms = mp_report(dev)
    for case in ("tp_report", "sp_report"):
        report, ms = got[0][case]
        if sorted(report) != sorted(one_report) or any(
                g[case][0] is not None for g in got[1:]):
            raise AssertionError(f"phase 16 {case}: parameters "
                                 f"{sorted(report)} vs {sorted(one_report)}")
        gap = report_gap(report, one_report)
        log(f"[mp {case[:2]} report {MP_WORLD} ranks float32] gradient-flow "
            f"report of bert hidden {BERT['hidden_size']} x "
            f"{BERT['num_layers']} layers, window {BERT['max_seq_len']}, "
            f"batch {MP_BATCH}, {len(report)} parameters, rank 0 over the "
            f"joined weights: largest relative gap from one process's "
            f"report on the same weights and batch, mean |grad| "
            f"{gap['mean_abs_grad'][0]:.3e} ({gap['mean_abs_grad'][1]}), "
            f"max |grad| {gap['max_abs_grad'][0]:.3e} "
            f"({gap['max_abs_grad'][1]}) (bound {MP_REPORT_RTOL}); ms "
            f"{[round(g[case][1], 1) for g in got]}, one process "
            f"{one_ms:.1f}; {card}")
        if not max(v[0] for v in gap.values()) <= MP_REPORT_RTOL:
            raise AssertionError(f"phase 16 {case}: {gap}")


def mp_phase(records: list, dev, base: Path) -> None:
    """Phase 16: tensor and sequence parallelism and the batch-split entry
    points (see the module's docstring)."""
    import torch

    card = card_line()
    t_phase = time.perf_counter()
    out = base / "mp16"
    t0 = time.perf_counter()
    run_ranks(out, MP_WORLD, {"case": "mp16"})
    ranks_s = time.perf_counter() - t0
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(MP_WORLD)]
    log(f"[mp ranks] {MP_WORLD} ranks of this script sharing {dev} over "
        f"gloo: {ranks_s:.1f} s from start to exit (TP 2 and SP 2 bert, the "
        "sharded entry points, the sharded ensemble); the ms below are of "
        "a card the ranks time-slice, not speed figures")
    # C9, the card's noise floor: two one-process Trainers, default and
    # deterministic algorithms
    c9 = c9_cases(dev)
    log(c9_line("default", c9, card))
    run_ranks(out / "c9det", 1, {"case": "c9det"},
              env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    c9_det = torch.load(out / "c9det" / "rank0.pt", weights_only=False)
    log(c9_line("deterministic", c9_det, card)
        + f"; warnings {c9_det['warnings']}")
    floor = c9["bert"]["after"]
    # (a) TP 2 and (b) SP 2 against one process
    one = {"f32": mp_bert_run(dev, "float32", True),
           "bf16": mp_bert_run(dev, "bfloat16", False)}
    launches = {"float32": {}, "bfloat16": {}}
    for case, ref, tol in (("tp_f32", one["f32"], "float32"),
                           ("sp_f32", one["f32"], "float32"),
                           ("sp_bf16", one["bf16"], "bfloat16")):
        err = mp_compare(case, got[0][case], ref, floor, card)
        for r in range(MP_WORLD):
            g = got[r][case]
            key = f"mp_{case[:2]}_eval_r{r}"
            if case == "tp_f32":  # full-window B5 on 6 heads a rank
                records[5]["launches_by_path"][key] = g["eval_launches"]
            else:
                launches[tol][key] = g["eval_launches"]
            err["logits"] = max(err["logits"], float(
                (g["logits"] - ref["logits"]).abs().max()))
        ranks_eq = len({g[case].get("loss") for g in got}) == 1
        train = ""
        if "loss" in err:
            train = (f"; one training step: loss {got[0][case]['loss']:.7f} "
                     f"vs {ref['loss']:.7f} ({err['loss']:.3e} relative, "
                     f"bound {MP_LOSS_RTOL}), gradients at "
                     f"{err['grad_excess']:.3f} of JAX's tolerance (rtol "
                     f"{MP_GRAD_TOL['rtol']}, atol {MP_GRAD_TOL['atol']}; "
                     f"worst {err['grad_worst']}), weights after AdamW "
                     f"{err['weights']:.3e} relative (bound "
                     f"{err['weights_bound']:.3e}: {MP_WEIGHT_RTOL}, or C9's "
                     f"floor {floor:.3e}), the step moved {err['moved']} "
                     f"tensors by lr / 2 or more in one process, each of "
                     f"them on the ranks by at least {err['step_lr']:.3f} "
                     f"lr (unmoved: {err['unmoved']}); step ms "
                     f"{[round(g[case]['step_ms'], 2) for g in got]}, one "
                     f"process {ref['step_ms']:.2f}")
        heads = BERT["hidden_size"] // HEAD_DIM
        split = (f"{heads // MP_WORLD} heads a rank" if case == "tp_f32"
                 else f"{BERT['max_seq_len'] // MP_WORLD} rows a rank")
        log(f"[mp {case[:2]} {MP_WORLD} ranks {tol}] bert hidden "
            f"{BERT['hidden_size']}, {heads} heads ({split}), "
            f"{BERT['num_layers']} layers, window {BERT['max_seq_len']}, "
            f"batch {MP_BATCH}, random lengths with a 0: eval pass (B5) "
            f"logits {err['logits']:.3e} max abs apart from one process "
            f"(bound {MP_LOGIT_ATOL[tol]}), B5 launches per rank "
            f"{[g[case]['eval_launches'] for g in got]} (one process "
            f"{ref['eval_launches']}), eval ms "
            f"{[round(g[case]['eval_ms'], 2) for g in got]}, one process "
            f"{ref['eval_ms']:.2f}{train}; the ranks agree: {ranks_eq}; "
            f"{card}")
        bad = (not err["logits"] <= MP_LOGIT_ATOL[tol] or not ranks_eq
               or min(g[case]["eval_launches"] for g in got) < 1)
        if "loss" in err:
            bad = bad or not (err["loss"] <= MP_LOSS_RTOL
                              and err["grad_excess"] <= 1.0
                              and err["weights"] <= err["weights_bound"]
                              and err["moved"] > 0 and not err["unmoved"])
        if bad:
            raise AssertionError(f"phase 16 {case}: {err}")
    del one
    bwd_launches = {d: {"dkv": {}, "dq": {}} for d in launches}
    mp_flash_grad_check(records, dev, got, floor, card, launches,
                        bwd_launches)
    b5_query_block(records, launches)
    b5_query_block_bwd(records, bwd_launches)
    # (c) the batch-split entry points against one process
    ref = mp_serve(dev, None)
    for r, g in enumerate(got):
        s = g["serve"]
        lines = []
        for what in ("tokens", "lstm", "bert"):
            if what == "tokens":
                apart = int((s["tokens"] != ref["tokens"]).sum())
                probs = 0.0
            else:
                apart = int((s[what][0] != ref[what][0]).sum()
                            + (s[what][1] != ref[what][1]).sum())
                probs = float((s[what][2] - ref[what][2]).abs().max())
            lines.append(f"{what} {apart} tokens apart, probs {probs:.3e}")
            if apart or not probs <= MP_PROBS_ATOL:
                raise AssertionError(f"phase 16 serve rank {r} {what}: "
                                     f"{apart} tokens apart, probs {probs}")
        records[0]["launches_by_path"][f"mp_serve_r{r}"] = sum(
            s[f"{w}_launches"][0] for w in ("tokens", "lstm", "bert"))
        records[2]["launches_by_path"][f"mp_serve_lstm_r{r}"] = \
            s["lstm_launches"][1]
        records[5]["launches_by_path"][f"mp_serve_bert_r{r}"] = \
            s["bert_launches"][2]
        log(f"[mp serve rank {r}] serve_sharded (lstm; bert f32 on B5) and "
            f"tokens_sharded, {MP_SERVE_CLIPS} clips over {MP_WORLD} ranks, "
            f"against one process: {'; '.join(lines)} (bound "
            f"{MP_PROBS_ATOL}); launches B1/B3/B5 tokens "
            f"{s['tokens_launches']}, lstm {s['lstm_launches']}, bert "
            f"{s['bert_launches']}, one process {ref['tokens_launches']}, "
            f"{ref['lstm_launches']}, {ref['bert_launches']}; {card}")
    # (d) the sharded ensemble against the unsharded one; beside it a
    # second unsharded run and one process's K 1 of each member's seed
    ref, again = mp_ensemble(dev, None), mp_ensemble(dev, None)
    solo = [mp_ensemble(dev, None, seeds=[s]) for s in ref["seeds"]]
    floor_apart = ens_apart(again, ref)
    log(f"[mp ensemble cause] one process, the same card: a second K 2 "
        f"against the first: losses {floor_apart[0]:.3e} relative, mAP "
        f"{floor_apart[1]:.3e} apart; K 1 of member i's seed against member "
        f"i of K 2: " + ", ".join(
            "losses {:.3e}, mAP {:.3e}".format(*ens_apart(o, ref, slice(i,
                                                                         i + 1)))
            for i, o in enumerate(solo)) + f"; {card}")
    for r, g in enumerate(got):
        e = g["ensemble"]
        apart = {key: np.abs(np.asarray(e[key]) - ref[key])
                 for key in ("loss", "v_loss", "per", "v_per")}
        jax_share = max(float(np.max(d / (MP_ENS_JAX_TOL["atol"]
                                          + MP_ENS_JAX_TOL["rtol"]
                                          * np.abs(ref[key]))))
                        for key, d in apart.items())
        losses, maps = ens_apart(e, ref)
        mine = slice(r * e["local"], (r + 1) * e["local"])
        vs_solo = ens_apart({k: np.asarray(e[k])[mine]
                             for k in ("loss", "v_loss", "per", "v_per")},
                            solo[r], members=slice(None, 1)) \
            if e["local"] == 1 else (float("nan"),) * 2
        records[2]["launches_by_path"][f"mp_ensemble_r{r}"] = e["launches"][0]
        records[3]["launches_by_path"][f"mp_ensemble_r{r}"] = e["launches"][1]
        log(f"[mp ensemble rank {r}] lstm K 2 over {MP_WORLD} ranks ({e['local']} a "
            f"rank), dropout 0.1, {MP_ENS_BATCHES} batches of {B_LSTM} + "
            f"{MP_ENS_VAL} validation clips, a training and the eval epoch "
            f"against the unsharded K 2: losses {losses:.3e} relative "
            f"(bound {MP_ENS_LOSS_RTOL}), member and ensemble mAP "
            f"{maps:.3e} apart (bound {MP_ENS_MAP_ATOL}); at "
            f"{jax_share:.3f} of the JAX test's CPU tolerance (rtol "
            f"{MP_ENS_JAX_TOL['rtol']}, atol {MP_ENS_JAX_TOL['atol']}); its "
            f"member against one process's K 1 of its seed: losses "
            f"{vs_solo[0]:.3e}, mAP {vs_solo[1]:.3e}; B3/B4 "
            f"launches {e['launches']}, unsharded {ref['launches']}; ms "
            f"{e['ms']:.1f}, unsharded {ref['ms']:.1f}; {card}")
        if not (losses <= MP_ENS_LOSS_RTOL and maps <= MP_ENS_MAP_ATOL) or min(
                e["launches"]) < 1:
            raise AssertionError(f"phase 16 ensemble rank {r}: losses "
                                 f"{losses}, mAP {maps}, {e['launches']}")
    # (e) the gradient-flow report on TP 2 and SP 2 against one process
    mp_report_check(dev, got, card)
    torch.cuda.empty_cache()
    log(f"[mp] phase 16 took {time.perf_counter() - t_phase:.1f} s (host "
        "clock)")


def n_padded(n: int, b: int) -> int:
    return -(-n // b) * b


def token_frames(cfg, split: str) -> int:
    """Frames the tokenize stage wrote for ``split`` (its token files)."""
    return sum(len(np.load(f, mmap_mode="r")) for f in
               (Path(cfg.dest_tokenized_path) / split).glob("*.npy"))


def corpus_wire(cfg, n_train: int, n_val: int) -> int:
    """Host-to-card bytes of the training stage's device-resident token
    corpora (``train/device_epoch.py``): each split's padded rows (uint16
    tokens, int32 lengths, uint8 labels) once, and each epoch's int64
    permutation of the padded training rows."""
    tok = 2 if cfg.vocab_size <= 0xFFFF else 4
    row = cfg.max_seq_len * tok + 4 + cfg.num_classes
    pad_train = n_padded(n_train, cfg.training_batch_size)
    pad_val = n_padded(n_val, cfg.eval_batch_size or cfg.training_batch_size)
    return (pad_train + pad_val) * row + cfg.epochs * pad_train * 8


def tools_wire(cfg, fused: bool, native: bool) -> dict:
    """Each stage's expected (h2d, d2h) bytes, from the run's split and
    token files and the config's shapes."""
    from audio_tokens_tpu_torch.ops.mel import num_frames

    split = json.loads(Path(cfg.split_file).read_text())
    n_train, n_val = len(split["train"]), len(split["validation"])
    bs = cfg.device_batch_size
    row = cfg.clip_samples + 2 * (cfg.n_fft // 2)  # pad + clip + pad
    frames_max = num_frames(cfg.clip_samples, cfg.hop_length)
    i16 = native and cfg.pcm_wire == "i16"
    wave = 2 if i16 else 4
    rows = {s: n_padded(n, bs) for s, n in (("train", n_train),
                                             ("validation", n_val))}
    frames = {s: token_frames(cfg, s) for s in rows}
    out = {"training": (corpus_wire(cfg, n_train, n_val), 0)}
    if fused:  # the device feed, then the resident frames and B1
        out["clustering"] = (rows["train"] * row * wave
                             + frames["train"] * 8, 0)
        out["tokenization"] = (
            rows["validation"] * row * wave if native else 0,
            frames["train"] * 8
            + (rows["validation"] * frames_max * 4 if native else 0))
    else:
        out["spectrograms"] = ((rows["train"] + rows["validation"]) * row
                               * wave, (rows["train"] + rows["validation"])
                               * cfg.n_mels * frames_max * 4)
        out["clustering"] = (0, 0)  # batch_warm_start: no metered site
        n = frames["train"] + frames["validation"]
        out["tokenization"] = (n * cfg.n_mels * 4, n * 8)
    return out


def check_tools_wire(tag: str, res: dict, want: dict, sections: tuple,
                     card: str) -> None:
    """Hold each stage's metered bytes to ``want`` exactly and its device
    seconds to (0, wall] where it has a section (``sections``)."""
    for stage, (h2d, d2h) in want.items():
        w, wall = res["wire"][stage], res["timings"][stage]
        got = (round(w["h2d_mb"] * 2**20), round(w["d2h_mb"] * 2**20))
        ok = got == (h2d, d2h)
        if stage in sections:
            ok = ok and 0 < w["device_s"] <= wall
        log(f"[tools {tag} wire] {stage}: h2d {got[0]} B, d2h {got[1]} B "
            f"(the arrays' arithmetic: {h2d}, {d2h}), device "
            f"{w['device_s']:.3f} s of {wall:.3f} s wall"
            f"{' (a device section)' if stage in sections else ''}; {card}")
        if not ok:
            raise AssertionError(f"phase 17 {tag} {stage}: wire {w}, wall "
                                 f"{wall}, expected {(h2d, d2h)}")


def trace_kernels(path: Path) -> list:
    """Names of the CUDA kernel events in a Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def trace_config(base: Path, **over):
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    return AudioTokensConfig(base_dir=str(base), dataset_ratio=1.0,
                             validation_ratio=0.25, num_classes=10, **over)


def tools_traces(dev, base: Path, cents_path: Path, card: str) -> None:
    """A staged spectrogram and tokenize run of TOOLS_TRACE_CLIPS clips
    with ``profile_dir``, in this long-lived process, where the profiler
    drops the first kernel records of every session (``maybe_trace``'s
    warm-up launches take them): each trace holds CUDA kernel events and
    a record of every launch of its stage, the tokenize trace B2's
    kernel; the records the warm-up lost are printed."""
    import shutil

    from audio_tokens_tpu_torch.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu_torch.data.splitter import DatasetSplitter
    from audio_tokens_tpu_torch.processors import (SpecTokenizer,
                                                   SpectrogramGenerator)
    from audio_tokens_tpu_torch.tools.smoke_run import make_corpus
    from audio_tokens_tpu_torch.utils import profiling

    make_corpus(base, TOOLS_TRACE_CLIPS)
    cfg = trace_config(base)
    DatasetSplitter(cfg).create_split_file(AudiosetMetadataProcessor(cfg))
    Path(cfg.centroids_path).parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(cents_path, cfg.centroids_path)
    stages = (("spec", "spectrogram_generator", SpectrogramGenerator),
              ("tokenize", "spec_tokenizer", SpecTokenizer))
    for stage, module, stage_cls in stages:
        out = base / f"traces_{stage}"
        t0 = time.perf_counter()
        stage_cls(trace_config(base, profile_dir=str(out)), dev).run()
        secs = time.perf_counter() - t0
        files = sorted(out.glob("trace_r0_*.json"))
        names = [trace_kernels(f) for f in files]
        counts = [profiling._launch_records(f) for f in files]
        b2 = [n for ks in names for n in ks if "vq_" in n]
        log(f"[tools trace {stage}] processors/{module}.py in this process, "
            f"{secs:.1f} s: {len(files)} traces (one a split), CUDA kernel "
            f"events {[len(k) for k in names]}, the stage's launches without "
            f"a record {[c[3] for c in counts]} of {[c[2] for c in counts]}, "
            f"the warm-up's {[c[1] for c in counts]} of "
            f"{[c[0] for c in counts]}; {sum(f.stat().st_size for f in files)}"
            f" bytes; B2 kernel events {len(b2)} ({sorted(set(b2))[:2]}); "
            f"{card}")
        if (len(files) != 2 or min(len(k) for k in names) < 1
                or any(c[3] for c in counts)
                or (stage == "tokenize" and not b2)):
            raise AssertionError(f"phase 17 traces of {stage}: {files}, "
                                 f"{[len(k) for k in names]}, {counts}, "
                                 f"B2 {len(b2)}")


def mount_type(path: Path) -> str:
    """The file system type of the mount that holds ``path``."""
    best, kind, target = "", "unknown", str(path.resolve())
    for line in Path("/proc/self/mounts").read_text().splitlines():
        mnt, typ = line.split()[1:3]
        mnt = mnt.replace("\\040", " ")
        inside = target == mnt or target.startswith(mnt.rstrip("/") + "/")
        if inside and len(mnt) > len(best):
            best, kind = mnt, typ
    return kind


def resident_after_advice(directory: Path, mb: int = 64) -> float:
    """Write and fsync an ``mb`` MiB file in ``directory``, advise the
    kernel to drop it (``POSIX_FADV_DONTNEED``, as ``bench_spill`` does
    before its cold read) and return the share of its pages still in the
    page cache (``mincore``)."""
    import ctypes
    import mmap

    path, size = directory / "advice_probe.bin", mb << 20
    with open(path, "wb") as f:
        f.write(np.ones(size, np.uint8).tobytes())
        f.flush()
        os.fsync(f.fileno())
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr in (None, ctypes.c_void_p(-1).value):
            raise OSError(ctypes.get_errno(), "mmap")
        pages = -(-size // mmap.PAGESIZE)
        vec = (ctypes.c_ubyte * pages)()
        rc = libc.mincore(addr, size, vec)
        libc.munmap(addr, size)
        if rc:
            raise OSError(ctypes.get_errno(), "mincore")
        return sum(v & 1 for v in vec) / pages
    finally:
        os.close(fd)
        path.unlink()


def tools_spill(card: str) -> None:
    """``bench_spill --gb 1`` in a directory of the checkout (``build/``),
    whose file system can honour the cache advice, unlike a tmpfs
    ``TMPDIR``; the cold leg is called cold only where the advice drops a
    fsynced probe file's pages there."""
    import shutil

    from audio_tokens_tpu_torch.tools import bench_spill

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    spill_dir = Path(tempfile.mkdtemp(prefix="spill_", dir=root))
    try:
        kind, left = mount_type(spill_dir), resident_after_advice(spill_dir)
        spill = bench_spill.main(["--gb", "1", "--path", str(spill_dir)])
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    if left < 0.01:
        leg = (f"a cold read: the advice dropped {1 - left:.1%} of a fsynced "
               f"64 MiB probe file's pages on this {kind} file system")
    else:
        leg = (f"a warm read in effect: the advice left {left:.1%} of a "
               f"fsynced 64 MiB probe file's pages cached on this {kind} "
               f"file system, so 'cold_replay_mb_s' is a page-cache rate")
    log(f"[tools bench_spill] {json.dumps(spill)} (the cold leg was {leg}; "
        f"{card})")


def tools_phase(records: list, dev, base: Path) -> None:
    """Phase 17: the tools (see the module's docstring)."""
    import shutil

    import torch

    from audio_tokens_tpu_torch.data import native_loader
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
    from audio_tokens_tpu_torch.tools import bench_loader, scale_run, smoke_run

    card = card_line()
    t_phase = time.perf_counter()
    kernels = {"B1": TokenizerKernel, "B2": vq_argmin, "sums": tier_sums64,
               "B3": lstm_sequence_fwd, "B4": lstm_sequence_bwd}
    rec = {"B1": records[0], "B2": records[1], "sums": sums_record(records),
           "B3": records[2], "B4": records[3]}
    dev_arg = str(dev)

    def counted(tag: str, must: tuple, fn):
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        for n in must:
            rec[n]["launches_by_path"][f"tools_{tag}"] = launches[n]
        log(f"[tools {tag}] {secs:.1f} s (host clock, corpus writing "
            f"included); launches {launches}; {card}")
        if min(launches[n] for n in must) < 1:
            raise AssertionError(f"phase 17 {tag}: a kernel of {must} never "
                                 f"launched: {launches}")
        return res

    smoke_ws, scale_ws = base / "smoke", base / "scale"
    res = counted("smoke_run", ("B1", "B2", "sums", "B3", "B4"),
                  lambda: smoke_run.main([
                      "--workspace", str(smoke_ws), "--n_clips",
                      str(TOOLS_SMOKE_CLIPS), "--epochs", "1",
                      "--model_type", "lstm", "--device", dev_arg]))
    cfg = res["config"]
    log(f"[tools smoke_run] stages {({k: round(v, 2) for k, v in res['timings'].items()})} s, "
        f"val mAP {res['val_metrics']['mAP']:.4f}; top rows "
        f"{[(r['name'], round(r['score'], 4)) for r in res['rows'][:2]]}")
    check_tools_wire("smoke_run", res, tools_wire(
        cfg, False, native_loader.select_backend(cfg)), ("training",), card)

    res = counted("scale_run", ("B1", "B2", "sums"), lambda: scale_run.main([
        "--workspace", str(scale_ws), "--n_clips", str(TOOLS_SCALE_CLIPS),
        "--niter", str(TOOLS_SCALE_NITER), "--epochs", "1", "--device",
        dev_arg]))
    cfg = res["config"]
    if not (cfg.fused_pipeline and cfg.kmeans_mode == "full"
            and cfg.pcm_wire == "i16"):
        raise AssertionError(f"phase 17 scale_run config {cfg}")
    check_tools_wire("scale_run", res, tools_wire(
        cfg, True, native_loader.select_backend(cfg)),
        ("clustering", "tokenization", "training"), card)
    saved = json.loads((scale_ws / "output" / "scale_run_timings.json")
                       .read_text())
    log(f"[tools scale_run] {TOOLS_SCALE_CLIPS} clips, fused, device feed, "
        f"niter {TOOLS_SCALE_NITER}: the clustering stage's measured rate "
        f"{res['point_iters_per_s']:.6e} point-iterations/s (train frames x "
        f"niter over its {saved['wire']['clustering']['device_s']:.3f} "
        f"device s); stage wall s {({k: round(v, 3) for k, v in saved['timings'].items()})}; "
        f"val mAP {saved['val_mAP']:.4f}; JSON keys {sorted(saved)}; {card}")

    tools_traces(dev, base / "traces", smoke_ws / "output" / "centroids.npy",
                 card)

    tools_spill(card)
    rates = bench_loader.main(["--n_clips", "2000"])
    log("[tools bench_loader] 2000 clips of 1728 tokens, batch 64: " + ", ".join(
        f"workers {w}: {b:.1f} batches/s, {c:.0f} clips/s"
        for w, (b, c) in rates.items()) + f"; {card}")
    for ws in (smoke_ws, scale_ws, base / "traces"):
        shutil.rmtree(ws / "audioset", ignore_errors=True)
    log(f"[tools] phase 17 took {time.perf_counter() - t_phase:.1f} s (host "
        "clock); the wav corpora deleted")


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
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
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
    phase_done(1)

    # -- 2. build ---------------------------------------------------------
    secs = _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {secs:.1f} s")
    for name in _build.KERNELS:
        for kernel, usage in ptxas_usage(_build.BUILD_DIR / f"lib{name}.log"):
            log(f"[build] {name} {kernel}: {usage}")
    split_procs = start_split_builds()  # phase 12's, built meanwhile
    phase_done(2)

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
    records.append(b2[0])  # B2 at K 16,384 and d 128 go last (records[10:])
    # B2's sliced ring instance (rows wider than d 100): the same batch's
    # frames at D_WIDE mel bins, K 500
    wide = MelFrontend(dev, SR, D_WIDE, cfg.n_fft, cfg.hop_length,
                       cfg.clip_samples).mel_frames(x).reshape(-1, D_WIDE)
    cents_wide = make_centroids(VOCAB, 9, D_WIDE)
    c_t = torch.from_numpy(cents_wide).to(dev)
    got = vq_argmin(wide, c_t, True)
    ref = vq_argmin_plain(wide, c_t, True)
    torch.cuda.synchronize()
    frac, gap = check_near_ties(l2_normalize(wide), c_t, got, ref)
    ms = cuda_ms(lambda: vq_argmin(wide, c_t, True), 10)
    plain_ms = cuda_ms(lambda: vq_argmin_plain(wide, c_t, True), 5)
    # yardstick: one torch.matmul over all rows, then argmin (TF32 off)
    lib_ms = cuda_ms(lambda: vq_argmin_plain(wide, c_t, True,
                                             chunk=wide.shape[0]), 5)
    n, k = wide.shape[0], VOCAB
    b_ms, b_by = bound_of(2 * n * D_WIDE * k + 3 * n * D_WIDE,
                          wide.numel() * 4 + cents_wide.nbytes + n * 4)
    log(f"[B2 vq] ids ({n},), d {D_WIDE}, K {k} (the sliced ring "
        f"instance): {frac:.2e} disagree, largest score gap {gap:.3e}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul + "
        f"argmin over all rows {lib_ms:.3f} ms; bound {b_ms:.3f} ms "
        f"({b_by}); {2 * n * D_WIDE * k / ms / 1e9:.1f} TFLOP/s")
    b2.append(dict(
        name=f"B2 vq (normalize + nearest centroid), d {D_WIDE} (sliced "
        "ring)", route="cuda", source="audio_tokens_tpu_torch/csrc/vq.cu",
        replaces="audio_tokens_tpu/ops/pallas_vq.py:37", max_abs_err=gap,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, matmul_argmin_ms=lib_ms))
    del wide, c_t, got, ref

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
    records.extend(b2[1:])
    phase_done(3)

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
        check_served(tokens, n_valid, probs, b, tok.frontend.frames_max,
                     cfg.num_classes, vocab)

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

    # frames of D_WIDE mel bins through the normalize route: B2's sliced
    # ring instance
    cfg_w = AudioTokensConfig(clip_seconds=CLIP_SECONDS,
                              **{**MODEL, "n_mels": D_WIDE}, normalize=True)
    prog_w = ServingProgram.from_components(
        cfg_w, FusedTokenizer(cfg_w, cents_wide, dev), device=dev,
        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    vq_argmin.launches = 0
    t0 = time.perf_counter()
    out_w = prog_w(torch.from_numpy(pb), torch.from_numpy(pl))
    torch.cuda.synchronize()
    wide_ms = (time.perf_counter() - t0) * 1e3
    wide_launches = vq_argmin.launches
    check(*out_w, BATCH)
    log(f"[serve d{D_WIDE}] lstm, {D_WIDE} mel bins, normalize=True: batch "
        f"of {BATCH} took {wide_ms:.1f} ms (host clock, first call); "
        f"launches B2 {wide_launches}")
    if wide_launches < 1:
        raise AssertionError(f"B2 never launched on the d {D_WIDE} batch")
    b2[2]["launches_by_path"] = {f"serve_d{D_WIDE}": wide_launches}
    del prog_w, out_w

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
    phase_done(4)

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
    phase_done(5)

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
        STREAM_STEP_MS["lstm"] = statistics.median(step_ms[1:])
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
        phase_done(6)

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
        STREAM_STEP_MS["bert"] = statistics.median(step_ms[1:])
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
        phase_done(7)

        # -- 8. the pipeline, wav files to a trained checkpoint --------------
        with tempfile.TemporaryDirectory() as tmp8:
            pipe = Path(tmp8)
            staged_cfg, staged_cents = pipeline_phase(records, dev, pipe)
            phase_done(8)
            # -- 9. the fused pipeline on phase 8's workspace -----------------
            fused_phase(records, dev, pipe, staged_cfg, staged_cents)
            phase_done(9)
            # -- 10. every family trains and serves from its checkpoint -------
            families_phase(records, dev, pipe, staged_cfg,
                           Path(bt_cfg.checkpoint_dir))
            phase_done(10)
            # -- 11. the serving export and serve_bench -----------------------
            python_bench = export_phase(records, dev, pipe, staged_cfg,
                                        Path(bt_cfg.checkpoint_dir))
            phase_done(11)
            # -- 12. the tiers, the conv front-end, the native decoder ---------
            tiers_phase(records, dev, pipe, staged_cfg, staged_cents,
                        python_bench, split_procs)
            phase_done(12)
            # -- 13. device-resident epochs, remat, diagnostics -----------------
            with tempfile.TemporaryDirectory() as tmp13:
                device_phase(records, dev, Path(tmp13))
            phase_done(13)
            # -- 14. ensembles and LR sweeps ------------------------------------
            with tempfile.TemporaryDirectory() as tmp14:
                ensemble_phase(records, dev, Path(tmp14))
            phase_done(14)
            # -- 15. multi-process and data parallel, on phase 8's workspace ----
            dp_phase(records, dev, pipe)
            phase_done(15)
            # -- 16. tensor and sequence parallelism, the sharded entry points -
            mp_phase(records, dev, pipe)
            phase_done(16)
            # -- 17. the tools, the wire meter, stage traces ----------------------
            with tempfile.TemporaryDirectory() as tmp17:
                tools_phase(records, dev, Path(tmp17))
            phase_done(17)

    for rec in records:
        rec["launches"] = sum(rec["launches_by_path"].values())
    print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2:]))
    sys.exit(main())
