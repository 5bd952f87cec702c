"""A/B the tuning knobs of the hand-written kernels on one card.

    python -m audio_tokens_tpu_torch.tools.kernel_ab
        --kernel attention|attention-f32|lstm|lstm-dw|lstm-fwd|tokenizer|vq
                 |tokenizer-tier|vq-tier|kmeans
        [--rounds 5] [--variant NAME:KEY=VAL,KEY=VAL ...]
        [--source NAME:path/<source>.cu[:KEY=VAL,..]]

Each variant is the case's ``csrc/<source>.cu`` compiled with other values
of its ``ATK_*`` knobs into ``build/kernels/ab/``; ``--source`` adds another
file with the same C interface (an earlier commit's kernels, say) under a
name, with its own knobs after a second colon.  All are built in parallel (one nvcc each), then timed in turns,
round after round (CUDA events, 10 launches a reading, 2 for the LSTM
kernels), on the shapes ``chip_smoke.py`` uses:

- ``attention`` (kernel B5 in bf16; knobs ``ATK_FWD_WARPS``,
  ``ATK_FWD_BLOCKS``, ``ATK_DKV_WARPS``, ``ATK_DKV_BLOCKS``,
  ``ATK_DQ_WARPS``, ``ATK_DQ_BLOCKS``, ``ATK_STAGES``, ``ATK_BWD_UNROLL``,
  ``ATK_TILE_SKIP``, ``ATK_PLAIN_TILES``): the forward at (64, 12, 1728,
  64) as ``[B5 attention]`` and the dk/dv and dq kernels at (8, 12, 1728,
  64) as ``[B5 backward]``, random prefix lengths with a 0, and the one
  model-level step that reaches all three: a weighted-BCE loss + backward
  through an eval-mode forward of the bert classifier at its full width
  (hidden 768, 12 heads, 2 layers, window 1728, bf16, ``"flash"``) on 4
  rows;
- ``attention-f32`` (B5's f32 kernels in 3xTF32, ``attention.cu``; knobs
  ``ATK_F32_SPLIT``, ``ATK_STAGES``, ``ATK_TILE_SKIP``,
  ``ATK_PLAIN_TILES``): the forward at
  (64, 12, 1728, 64) f32 beside ``scaled_dot_product_attention``'s f32
  forward on the same inputs, the dk/dv and dq kernels at (8, 12, 1728, 64)
  f32 and the pair, beside sdpa's f32 backward (dq, dk and dv together) on
  the same inputs, random prefix lengths with a 0, and the f32 eval-mode
  bert loss + backward on 4 rows (the model of ``attention`` with
  ``compute_dtype="float32"``); each variant's largest difference from the
  plain version (absolute for the forward's o and logsumexp, over the
  largest entry for the gradients), and whether two launches give the same
  bits.  With ``--source parent:<an earlier attention.cu>`` the earlier f32
  kernels (plain FMA before the 3xTF32 ones) are timed in turns;
- ``lstm`` (kernel B4; knobs ``ATK_LSTM_BWD_UNITS``, ``ATK_LSTM_BWD_ROWS``,
  ``ATK_LSTM_BWD_THREADS``, ``ATK_LSTM_BWD_UNROLL``): both directions at
  T 1728, B 64, H 512 as
  ``[B4 lstm backward]``, the whole backward and its ``dw_hh`` GEMM alone,
  the recurrence being the difference;
- ``lstm-dw`` (B4's ``dw_hh`` GEMM, ``lstm.cu``; knobs ``ATK_LSTM_DW_BK``,
  ``ATK_LSTM_DW_STAGES``, ``ATK_LSTM_DW_SLICES``): the GEMM alone, both directions at T 1728, B 64, H 512, beside cuBLAS
  (``torch.matmul``, TF32 off) on the same time-shifted views; each
  variant's largest difference from the plain version over the largest
  entry, and whether two launches give the same bits.  An ``lstm.cu``
  from before the chunk carries has another C interface: time it by
  running this tool from that commit's package (``git archive``) in turns
  with this one;
- ``lstm-fwd`` (kernel B3, ``lstm.cu``): both directions at T 1728, B 64,
  H 512 as ``[B3 lstm]``, without and with the residual stores, and the
  largest difference from the plain version;
- ``tokenizer`` (kernel B1, ``tokenizer.cu``; knob
  ``ATK_TOKENIZER_FRAMES``, 128 or 64 frames a block): 64 ten-second
  synthetic clips, K 500, as ``[B1 tokenizer]``; each variant's tokens are
  held to the plain version under the near-tie rule (the fraction that
  disagrees and the largest score gap are printed);
- ``vq`` (kernel B2, ``vq.cu``; knobs ``ATK_VQ_STAGES``, ``ATK_VQ_RING``):
  the normalize + nearest-centroid assignment of the serving batch's
  110,272 log-mel frames (64 ten-second clips, d 64) at K 500 and at
  K 16,384 (unit centroids from seeds 7 and 8), and the same clips' 128-mel
  frames at K 500 (seed 9; the rows too wide for the whole-row ring, walked
  in feature slices), also normalized beforehand and assigned with
  ``normalize=False`` (the normalization's share), each variant's ids held
  to the plain version under the near-tie rule;
- ``vq-tier`` (B2 at the bf16x3 and default tiers, ``vq.cu``'s tiered
  instance; knob ``ATK_TIER_SPLIT``): the Lloyd assignment's 17.23M x 64
  x 500 (one default clustering batch of Gaussian rows, centroids drawn
  from them), K 16,384 at N 110,272, d 128 at K 500 on 110,272 rows and
  d 640 (the conv front-end's) at K 500 on 882,176 rows, both tiers each,
  ``normalize=False`` as the Lloyd loop calls it; each variant's ids held
  to the plain tier version under ``check_tier_ties`` (on the first
  262,144 rows of the 17.23M); a shape a source refuses is reported so;
- ``kmeans`` (the centroid sums, ``kmeans.cu``; knobs ``ATK_SUMS_UNROLL``,
  rows a warp loads a group, ``ATK_SUMS_PIPELINE``, the next group loaded
  while this one is summed, ``ATK_SUMS_BLOCKS``, blocks an SM must hold):
  ``tier_sums64`` at each tier on one default clustering batch's 17.23M x
  64 unit rows and K 500, the sort included; every variant's sums must
  equal the default build's bit for bit;
- ``tokenizer-tier`` (B1's tiered argmin and bf16 front end,
  ``tokenizer.cu``; knob ``ATK_TIER_SPLIT``): ``FusedTokenizer`` at (highest, bf16x3), (bf16x3,
  bf16x3) and (default, default) on 64 ten-second clips at K 500 and
  16,384, tokens held to the plain tier version under ``check_tier_ties``.

``ATK_TIER_SPLIT`` splits the tiered product's time (``common.cuh``): 1
drops the compare-select epilogue, 2 the products, 3 both, leaving the
copies, barriers and fragment loads; in B2 4 drops the frame tiles' copies
and waits (4: products and epilogue, 5: products, 6: epilogue alone; wrong
ids, by design: ``--variant compute-only:ATK_TIER_SPLIT=4``).  In B1's
bf16 front end (``tokenizer.cu``, the tier combos other than highest) 8
drops the DFT products, 16 the mel products, 24 both (the front end's
staging only: the waveform window, the basis and filterbank copies, the
barriers and the fragment loads), 32 the argmin, 64 the waveform
window's loads; the argmin runs as in the default build unless 32 is
set.
``ATK_VQ_TMA=0`` stages B2's frame tiles by cp.async instead of the tensor
map.  ``tools/tier_mma_sync_split.patch`` adds the knob to the earlier
mma.sync design of the tiered product, ``tools/b1_mma_sync_front_split.patch``
bits 8-24 to B1's earlier mma.sync front end (each header says how to
time that tree).

A variant built with ``ATK_LSTM_TIMERS=1`` (``lstm`` and ``lstm-fwd``)
also reports its per-phase cycle counters (``b3_unit4_timers.patch`` adds
them to B3's earlier 4-unit design, timed from that commit's package):
after the timing rounds one
more call runs with the counters zeroed, and the script prints each
phase's mean cycles a step (over blocks; thread 0 of each block marks the
phases) and its share of the step.

Per variant the script prints ptxas' registers and spills of the kernels
it times, the median and the spread of each time over the rounds, a
sha256 of its outputs (the same inputs in every process: two runs of the
tool, from two commits' packages, compare bit for bit by it), and
whether its outputs equal the default build's bit for bit.  Every knob of
B5 must keep them (the tile skip and the untested path on full tiles
included: no B5 knob changes a sum's order or a value, and
``ATK_F32_SPLIT=0`` splits by ``cvt.rna`` to the same bits), and so must
B4's
unrolling; B4's units, rows and threads a block change which sums its warps
take, B1's frames a block how its mel sums are grouped, and the
``dw_hh`` GEMM's k-rows a stage and slices where its partial sums split,
so their outputs differ in the last bits, as another source's may.  The last line is the card as nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from audio_tokens_tpu_torch.ops import _build

TIER_SPLIT_VARIANTS = ("default:", "no-epilogue:ATK_TIER_SPLIT=1",
                       "no-products:ATK_TIER_SPLIT=2",
                       "staging-only:ATK_TIER_SPLIT=3")
DEFAULT_VARIANTS = {
    "attention": (
        "default:",
        "fwd-8-warps-2-blocks:ATK_FWD_WARPS=8,ATK_FWD_BLOCKS=2",
        "fwd-6-warps-2-blocks:ATK_FWD_WARPS=6,ATK_FWD_BLOCKS=2",
        "fwd-4-warps-3-blocks:ATK_FWD_BLOCKS=3",
        "fwd-6-warps-3-blocks:ATK_FWD_WARPS=6,ATK_FWD_BLOCKS=3",
        "no-skip:ATK_TILE_SKIP=0",
        "mask-every-tile:ATK_PLAIN_TILES=0",
        "stages-3:ATK_STAGES=3",
    ),
    "attention-f32": (
        "default:",
        "split-cvt:ATK_F32_SPLIT=0",
        "no-skip:ATK_TILE_SKIP=0",
        "mask-every-tile:ATK_PLAIN_TILES=0",
    ),
    "lstm-fwd": ("default:", "timers:ATK_LSTM_TIMERS=1"),
    "tokenizer": ("default:", "f64:ATK_TOKENIZER_FRAMES=64"),
    "lstm-dw": (
        "default:",
        "stages-3:ATK_LSTM_DW_STAGES=3",
        "stages-5:ATK_LSTM_DW_STAGES=5",
        "slices-8:ATK_LSTM_DW_SLICES=8",
        "bk8:ATK_LSTM_DW_BK=8,ATK_LSTM_DW_STAGES=3",
    ),
    "vq": ("default:", "ring:ATK_VQ_RING=1", "ring-2-stages:ATK_VQ_STAGES=2",
           "ring-4-stages:ATK_VQ_STAGES=4"),
    "vq-tier": TIER_SPLIT_VARIANTS,
    "kmeans": ("default:", "unroll-4:ATK_SUMS_UNROLL=4",
               "no-pipeline:ATK_SUMS_UNROLL=4,ATK_SUMS_PIPELINE=0",
               "unroll-8-2-blocks:ATK_SUMS_UNROLL=8,ATK_SUMS_BLOCKS=2",
               "no-cap:ATK_SUMS_BLOCKS=0"),
    "tokenizer-tier": TIER_SPLIT_VARIANTS + (
        "no-dft:ATK_TIER_SPLIT=8", "no-mel:ATK_TIER_SPLIT=16",
        "front-staging-only:ATK_TIER_SPLIT=24", "no-argmin:ATK_TIER_SPLIT=32",
        "staging-no-argmin:ATK_TIER_SPLIT=56",
        "staging-no-argmin-no-window:ATK_TIER_SPLIT=120"),
    "lstm": (
        "default:",
        "timers:ATK_LSTM_TIMERS=1",
        "u16-r16:ATK_LSTM_BWD_UNITS=16,ATK_LSTM_BWD_ROWS=16",
        "u16-r32:ATK_LSTM_BWD_UNITS=16,ATK_LSTM_BWD_ROWS=32",
        "u8-r64:ATK_LSTM_BWD_ROWS=64",
        "unroll-1:ATK_LSTM_BWD_UNROLL=1",
        "unroll-4:ATK_LSTM_BWD_UNROLL=4",
        "u8-1024-threads:ATK_LSTM_BWD_THREADS=1024",
    ),
}
# the kernels whose registers and spills are reported: (mangled name part,
# label)
PTXAS_KERNELS = {
    "attention": (("flash_fwd_mma", "fwd"), ("flash_dkv_mma", "dk/dv"),
                  ("flash_dq_mma", "dq")),
    "attention-f32": (("flash_fwd_tf32", "fwd 3xTF32"),
                      ("flash_dkv_tf32", "dk/dv 3xTF32"),
                      ("flash_dq_tf32", "dq 3xTF32"),
                      ("flash_fwd_kernel", "fwd FMA (earlier design)"),
                      ("flash_dkv_kernel", "dk/dv FMA (earlier design)"),
                      ("flash_dq_kernel", "dq FMA (earlier design)")),
    "lstm": (("lstm_bwd_kernelILi8ELi512E", "B4<8,512>"),
             ("lstm_bwd_kernelILi8ELi1024E", "B4<8,1024>"),
             ("lstm_bwd_kernelILi16ELi512E", "B4<16,512>")),
    "lstm-fwd": (("lstm_fwd_kernel", "B3"),),
    "lstm-dw": (("lstm_dw_kernel", "dw_hh"), ("lstm_dw_sum_kernel", "slice sum")),
    "vq": (("vq_resident_kernelILb1E", "B2 resident"),
           ("vq_ring_kernelILb1ELb0E", "B2 ring"),
           ("vq_ring_kernelILb1ELb1E", "B2 sliced ring"),
           ("vq_kernel", "B2 (first design)")),
    "tokenizer": (("tokenizer_kernelILi64ELb1E", "B1<64>"),
                  ("tokenizer_kernelILi128ELb1E", "B1<128>"),
                  ("tokenizer_kernelv", "B1 (first design)")),
    "vq-tier": (("vq_tier_kernelILi4ELb1ELb0E", "B2 tiered <4, bf16x3>"),
                ("vq_tier_kernelILi4ELb0ELb0E", "B2 tiered <4, default>"),
                ("vq_tier_kernelILi8ELb1ELb0E", "B2 tiered <8, bf16x3>"),
                ("vq_tier_kernelILi8ELb1ELb1E", "B2 tiered <8, bf16x3, wide>")),
    "kmeans": (("sums_runs_kernelILi0E", "sums runs highest"),
               ("sums_runs_kernelILi1E", "sums runs bf16x3"),
               ("sums_runs_kernelILi2E", "sums runs default"),
               ("sums_join_kernelILi2E", "sums join (2 parts)")),
    "tokenizer-tier": (("tokenizer_kernelILi128ELb1ELb1E", "B1<128> f32 + tier argmin"),
                       ("tokenizer_wg_kernelILi2ELb1ELb1E",
                        "B1 wgmma front end + tier argmin"),
                       ("tokenizer_wg_kernelILi1ELb0ELb1E",
                        "B1 wgmma front end, 64 frames, gathered fragments")),
}
SOURCES = {"attention": "attention", "attention-f32": "attention",
           "kmeans": "kmeans",
           "lstm": "lstm", "lstm-dw": "lstm", "lstm-fwd": "lstm",
           "tokenizer": "tokenizer", "vq": "vq", "vq-tier": "vq",
           "tokenizer-tier": "tokenizer"}
MODULES = {"attention": "cuda_attention", "attention-f32": "cuda_attention",
           "kmeans": "cuda_kmeans",
           "lstm": "cuda_lstm",
           "lstm-dw": "cuda_lstm", "lstm-fwd": "cuda_lstm",
           "tokenizer": "cuda_tokenizer", "vq": "cuda_vq",
           "vq-tier": "cuda_vq", "tokenizer-tier": "cuda_tokenizer"}
# the phases of the cycle counters (csrc/lstm.cu, ATK_LSTM_TIMERS)
TIMER_PHASES = {
    "lstm-fwd": ("inputs", "h loads", "product", "sum", "cell + stores",
                 "barrier"),
    "lstm": ("cell + stores", "barrier", "residual loads", "plane loads + "
             "product", "reduce-scatter", "block sum"),
}
T_LSTM, B_LSTM, H_LSTM = 1728, 64, 512
SM_SCALE = 0.125


def build_all(kernel: str, variants: Dict[str, Tuple[Path, List[str]]]
              ) -> Dict[str, Path]:
    """nvcc for every (source, defines), all started together."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, defines) in variants.items():
        lib = out_dir / f"lib{kernel}_{name}.so"
        cmd = _build.nvcc_command(SOURCES[kernel], lib, defines)
        cmd[-1] = str(source)
        cmd.insert(1, f"-I{_build.CSRC}")  # common.cuh for a source elsewhere
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (lib, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + lib.with_suffix(".log").read_text())
        libs[name] = lib
    return libs


def ptxas_summary(log: Path, kernels) -> str:
    """'label: N registers, S spill' for each of ``kernels`` (mangled name
    part, label) that the log shows."""
    found, current, spill = [], None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            current = next((label for part, label in kernels if part in line),
                           None)
        elif current and "spill stores" in line:
            spill = line.strip()
        elif current and "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            found.append(f"{current}: {regs}, {spill}")
            current = None
    return "; ".join(found)


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of fn on the card over ``reps`` calls (CUDA
    events), after one call to warm up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for kernel B5."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops import cuda_attention as ca
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    t = 1728

    def inputs(b):
        q, k, v, do = (torch.randn((b, 12, t, 64), generator=gen)
                       .to("cuda", torch.bfloat16) for _ in range(4))
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0] = 0
        seg = (torch.arange(t)[None, :] >= lens[:, None]).to(torch.int32)
        return q, k, v, do, seg.cuda(), lens

    fq, fk, fv, _, fseg, flens = inputs(64)
    q, k, v, do, seg, lens = inputs(8)
    o, lse = ca.flash_attention_fwd(q, k, v, seg, SM_SCALE, True)
    di = (o.float() * do.float()).sum(-1)
    call = (q, k, v, seg, lse, do, di, SM_SCALE)
    cfg = AudioTokensConfig(
        model_type="bert", vocab_size=500, hidden_size=768, num_layers=2,
        num_classes=543, max_seq_len=t, transformer_max_position=t,
        dropout=0.0, transformer_attention="flash")
    model = get_model(cfg, "cuda", torch.Generator().manual_seed(0)).eval()
    tokens = torch.randint(0, 500, (4, t), generator=gen,
                           dtype=torch.int32).cuda()
    labels = (torch.rand((4, 543), generator=gen) < 0.01).float().cuda()
    weights = torch.ones(4, device="cuda")

    def model_step() -> None:
        model.zero_grad(set_to_none=True)
        weighted_bce(model(tokens), labels, weights).backward()

    timed = {
        "fwd (64, 12, 1728, 64)": lambda: ca.flash_attention_fwd(
            fq, fk, fv, fseg, SM_SCALE),
        "dk/dv (8, 12, 1728, 64)": lambda: ca.flash_attention_bwd_dkv(*call),
        "dq": lambda: ca.flash_attention_bwd_dq(*call),
        "bert eval-mode loss + backward on 4 rows": model_step,
    }

    def outputs():
        return (*ca.flash_attention_fwd(fq, fk, fv, fseg, SM_SCALE, True),
                *ca.flash_attention_bwd_dkv(*call),
                ca.flash_attention_bwd_dq(*call))

    desc = (f"B5 bf16: forward prefix lengths {flens.tolist()}; backward "
            f"prefix lengths {lens.tolist()}")
    return desc, timed, outputs


def attention_f32_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for B5's f32
    kernels."""
    import torch
    import torch.nn.functional as F

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops import cuda_attention as ca
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    exact_f32()  # the plain version and sdpa's yardstick in full f32
    t, b = 1728, 8
    q, k, v, do = (torch.randn((b, 12, t, 64), generator=gen).cuda()
                   for _ in range(4))
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[0] = 0
    seg = (torch.arange(t)[None, :] >= lens[:, None]).to(torch.int32).cuda()
    o, lse = ca.flash_attention_fwd(q, k, v, seg, SM_SCALE, True)
    di = (o * do).sum(-1)
    call = (q, k, v, seg, lse, do, di, SM_SCALE)
    refs = (*ca.flash_attention_dkv_plain(*call),
            ca.flash_attention_dq_plain(*call))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(
        *leaves, attn_mask=seg[:, None, :, None] == seg[:, None, None, :],
        scale=SM_SCALE)
    cfg = AudioTokensConfig(
        model_type="bert", vocab_size=500, hidden_size=768, num_layers=2,
        num_classes=543, max_seq_len=t, transformer_max_position=t,
        dropout=0.0, transformer_attention="flash", compute_dtype="float32")
    model = get_model(cfg, "cuda", torch.Generator().manual_seed(0)).eval()
    tokens = torch.randint(0, 500, (4, t), generator=gen,
                           dtype=torch.int32).cuda()
    labels = (torch.rand((4, 543), generator=gen) < 0.01).float().cuda()
    weights = torch.ones(4, device="cuda")
    # the forward at the serving batch: its plain version once, kept
    fq, fk, fv = (torch.randn((64, 12, t, 64), generator=gen).cuda()
                  for _ in range(3))
    flens = torch.randint(1, t + 1, (64,), generator=gen)
    flens[0] = 0
    fseg = (torch.arange(t)[None, :] >= flens[:, None]).to(
        torch.int32).cuda()
    fref = ca.flash_attention_plain(fq, fk, fv, fseg, SM_SCALE, True)
    torch.cuda.empty_cache()
    fmask = fseg[:, None, :, None] == fseg[:, None, None, :]

    def model_step() -> None:
        model.zero_grad(set_to_none=True)
        weighted_bce(model(tokens), labels, weights).backward()

    def forward():
        return ca.flash_attention_fwd(fq, fk, fv, fseg, SM_SCALE, True)

    def pair():
        return (*ca.flash_attention_bwd_dkv(*call),
                ca.flash_attention_bwd_dq(*call))

    timed = {
        "fwd (64, 12, 1728, 64) f32": lambda: ca.flash_attention_fwd(
            fq, fk, fv, fseg, SM_SCALE),
        "sdpa f32 forward": lambda: F.scaled_dot_product_attention(
            fq, fk, fv, attn_mask=fmask, scale=SM_SCALE),
        "dk/dv (8, 12, 1728, 64) f32": lambda: ca.flash_attention_bwd_dkv(
            *call),
        "dq": lambda: ca.flash_attention_bwd_dq(*call),
        "the pair": pair,
        "sdpa f32 backward (dq, dk, dv)": lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True),
        "bert f32 eval-mode loss + backward on 4 rows": model_step,
    }

    def outputs():
        fwd, fwd_again = forward(), forward()
        got, again = pair(), pair()
        fwd_errs = [float((g - r).abs().max()) for g, r in zip(fwd, fref)]
        errs = [float((g - r).abs().max() / r.abs().max())
                for g, r in zip(got, refs)]
        same = all(torch.equal(x, y) for x, y in
                   zip((*fwd, *got), (*fwd_again, *again)))
        return (*fwd, *got), (
            "max abs err vs plain: "
            + ", ".join(f"{n} {e:.3e}" for n, e in
                        zip(("o", "lse"), fwd_errs))
            + "; max abs err / max |ref| vs plain: "
            + ", ".join(f"{n} {e:.3e}" for n, e in
                        zip(("dk", "dv", "dq"), errs))
            + f", bit-equal between launches: {same}")

    return (f"B5 f32: forward prefix lengths {flens.tolist()}; backward "
            f"prefix lengths {lens.tolist()}", timed, outputs)


def _lstm_inputs(gen):
    """B3's inputs at the serving and training shape: xg, w_hh, mask."""
    import torch

    t, b, h = T_LSTM, B_LSTM, H_LSTM
    xg = torch.randn((t, b, 4 * h), generator=gen).cuda()
    w_hh = ((torch.rand((h, 4 * h), generator=gen) * 2 - 1)
            / h ** 0.5).cuda()
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float().cuda()
    return xg, w_hh, mask


def lstm_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for kernel B4."""
    import torch

    from audio_tokens_tpu_torch.ops import cuda_lstm as cl

    t, b, h = T_LSTM, B_LSTM, H_LSTM
    xg, w_hh, mask = _lstm_inputs(gen)
    dhs = torch.randn((t, b, h), generator=gen).cuda()
    dh_last = torch.randn((b, h), generator=gen).cuda()
    args = {}
    for reverse in (False, True):
        hs, gates, c, _ = cl.lstm_sequence_fwd_plain(xg, mask, w_hh, reverse)
        args[reverse] = (dhs, dh_last, gates, c, hs, mask, w_hh, reverse)
    dxg = {r: cl.lstm_sequence_bwd(*args[r])[0] for r in (False, True)}

    def both_dw():
        return [cl.lstm_dw_hh(args[r][4], dxg[r], r) for r in (False, True)]

    timed = {
        "B4 both directions": lambda: [cl.lstm_sequence_bwd(*args[r])
                                       for r in (False, True)],
        "dw_hh GEMM alone": both_dw,
    }

    def outputs():
        return tuple(x for r in (False, True)
                     for x in cl.lstm_sequence_bwd(*args[r]))

    return f"B4: T {t}, B {b}, H {h}, f32", timed, outputs


def lstm_fwd_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for kernel B3."""
    from audio_tokens_tpu_torch.ops import cuda_lstm as cl

    xg, w_hh, mask = _lstm_inputs(gen)
    refs = [cl.lstm_sequence_fwd_plain(xg, mask, w_hh, r)
            for r in (False, True)]

    def both(residuals):
        return [cl.lstm_sequence_fwd(xg, mask, w_hh, r, residuals)
                for r in (False, True)]

    timed = {"B3 both directions": lambda: both(False),
             "with residuals": lambda: both(True)}

    def outputs():
        outs = tuple(x for got in both(True) for x in got)
        ref = tuple(x for r in refs for x in r)
        err = max(float((a - b).abs().max()) for a, b in zip(outs, ref))
        return outs, f"max abs err vs plain {err:.3e}"

    return (f"B3: T {T_LSTM}, B {B_LSTM}, H {H_LSTM}, f32, both directions",
            timed, outputs)


def lstm_dw_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for B4's dw_hh GEMM."""
    import torch

    from audio_tokens_tpu_torch.ops import cuda_lstm as cl

    t, b, h = T_LSTM, B_LSTM, H_LSTM
    hs = {r: torch.tanh(torch.randn((t, b, h), generator=gen)).cuda()
          for r in (False, True)}
    dxg = {r: (0.1 * torch.randn((t, b, 4 * h), generator=gen)).cuda()
           for r in (False, True)}
    refs = {r: cl.lstm_dw_hh_plain(hs[r], dxg[r], r) for r in (False, True)}
    # hs one step back in processing order against dxg
    shifted = {False: (slice(None, -1), slice(1, None)),
               True: (slice(1, None), slice(None, -1))}

    def both():
        return [cl.lstm_dw_hh(hs[r], dxg[r], r) for r in (False, True)]

    def cublas():
        return [torch.matmul(hs[r][shifted[r][0]].reshape(-1, h).t(),
                             dxg[r][shifted[r][1]].reshape(-1, 4 * h))
                for r in (False, True)]

    def outputs():
        got, again = both(), both()
        err = max(float((g - refs[r]).abs().max() / refs[r].abs().max())
                  for g, r in zip(got, (False, True)))
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        return tuple(got), (f"max abs err / max |dw_hh| vs plain {err:.3e}, "
                            f"bit-equal between launches: {same}")

    flop = 2 * 2 * (t - 1) * b * h * 4 * h
    return (f"dw_hh: T {t}, B {b}, H {h}, f32, both directions, "
            f"{flop / 1e9:.1f} GFLOP",
            {"dw_hh both directions": both,
             "cuBLAS torch.matmul, same views": cublas}, outputs)


def vq_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for kernel B2."""
    import numpy as np
    import torch

    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    clips = synthetic_clips(64)
    frames, cases = {}, {}
    for d in (64, 128):
        fe = MelFrontend("cuda", 22050, d, 512, 128, 220500)
        x = torch.from_numpy(fe.prepare_batch(clips)[0]).cuda()
        frames[d] = fe.mel_frames(x).reshape(-1, d).contiguous()
    for k, d, seed, norm in ((500, 64, 7, True), (16384, 64, 8, True),
                             (500, 128, 9, True), (500, 128, 9, False)):
        c = np.random.default_rng(seed).standard_normal((k, d))
        c = (c / (np.linalg.norm(c, axis=1, keepdims=True) + 1e-10))
        name = f"K {k}" if d == 64 else f"K {k}, d {d}"
        f = frames[d]
        if not norm:  # the same rows normalized beforehand
            name, f = name + ", normalize=False", l2_normalize(f)
        cases[name] = (f, torch.from_numpy(c.astype(np.float32)).cuda(), norm)
    refs = {name: vq_argmin_plain(*case) for name, case in cases.items()}

    def outputs():
        got, notes = [], []
        for name, (f, c, norm) in cases.items():
            ids = vq_argmin(f, c, norm)
            got.append(ids)
            try:
                frac, gap = check_near_ties(l2_normalize(f) if norm else f, c,
                                            ids, refs[name])
                notes.append(f"{name}: {frac:.2e} of ids differ from the "
                             f"plain version, largest score gap {gap:.3e}")
            except AssertionError as e:
                notes.append(f"{name}: FAILS the near-tie rule: {e}")
        return tuple(got), "; ".join(notes)

    timed = {name: (lambda case=case: vq_argmin(*case))
             for name, case in cases.items()}
    return (f"B2: {tuple(frames[64].shape)} log-mel frames (and d 128), "
            "normalize=True unless named",
            timed, outputs)


# vq-tier: (label, rows, d, K), each at both tiers
VQ_TIER_CASES = (("17.23M x 64 x 500", 17_230_000, 64, 500),
                 ("K 16384", 110_272, 64, 16384),
                 ("d 128", 110_272, 128, 500),
                 ("d 640", 882_176, 640, 500))
VQ_TIER_CHECK_ROWS = 1 << 18


def vq_tier_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for B2's tiers."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.tiers import check_tier_ties

    cases, refs = {}, {}
    card_gen = torch.Generator(device="cuda").manual_seed(6)
    for label, n, d, k in VQ_TIER_CASES:
        x = torch.randn((n, d), generator=card_gen, device="cuda")
        c = x[torch.randperm(n, generator=card_gen, device="cuda")[:k]].clone()
        for tier in ("bf16x3", "default"):
            name = f"{label} {tier}"
            cases[name] = (x, c, tier)
            refs[name] = vq_argmin_plain(x[:VQ_TIER_CHECK_ROWS], c, False,
                                         tier=tier)

    def outputs():
        got, notes = [], []
        for name, (x, c, tier) in cases.items():
            try:
                ids = vq_argmin(x, c, False, tier)
            except ValueError as e:
                notes.append(f"{name}: refused ({e})")
                continue
            got.append(ids)
            try:
                frac, _, worst = check_tier_ties(
                    x[:VQ_TIER_CHECK_ROWS], c, ids[:VQ_TIER_CHECK_ROWS],
                    refs[name], tier)
                notes.append(f"{name}: {frac:.2e} apart from the plain tier "
                             f"version ({worst:.3f} of the bound)")
            except AssertionError as e:
                notes.append(f"{name}: FAILS the tier's near-tie rule: {e}")
        return tuple(got), "; ".join(notes)

    def timed_fn(x, c, tier):
        def run():
            try:
                vq_argmin(x, c, False, tier)
            except ValueError:  # the source refuses the shape
                raise AttributeError("refused")
        return run

    timed = {name: timed_fn(*case) for name, case in cases.items()}
    return ("B2 tiers: Gaussian rows, centroids drawn from them, "
            "normalize=False", timed, outputs)


def tokenizer_tier_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for B1's tiers."""
    import numpy as np
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.tiers import check_tier_ties
    from audio_tokens_tpu_torch.ops.vq import l2_normalize
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    clips = synthetic_clips(64)
    kerns, x = {}, None
    for k, seed in ((500, 7), (16384, 8)):
        cents = np.random.default_rng(seed).standard_normal((k, 64))
        cents = (cents / (np.linalg.norm(cents, axis=1, keepdims=True)
                          + 1e-10)).astype(np.float32)
        for tier, vq in (("highest", "bf16x3"), ("bf16x3", "bf16x3"),
                         ("default", "default")):
            cfg = AudioTokensConfig(clip_seconds=10.0, vocab_size=k,
                                    tokenizer_precision=tier,
                                    tokenizer_vq_precision=vq)
            tok = FusedTokenizer(cfg, cents, torch.device("cuda", 0))
            if x is None:
                x = torch.from_numpy(tok.frontend.prepare_batch(clips)[0]
                                     ).cuda()
            kern = tok.kernel
            kerns[f"K {k} {tier}/{vq}"] = (
                kern, kern.plain(x), l2_normalize(kern.log_mel_plain(x)),
                "default" if "default" in (tier, vq) else "bf16x3")

    def outputs():
        got, notes = [], []
        for name, (kern, ref, unit, coarse) in kerns.items():
            ids = kern(x)
            got.append(ids)
            try:
                frac, _, worst = check_tier_ties(unit, kern.centroids, ids,
                                                 ref, coarse)
                notes.append(f"{name}: {frac:.2e} apart from the plain tier "
                             f"version ({worst:.3f} of the bound)")
            except AssertionError as e:
                notes.append(f"{name}: FAILS the tier's near-tie rule: {e}")
        return tuple(got), "; ".join(notes)

    timed = {name: (lambda kern=v[0]: kern(x)) for name, v in kerns.items()}
    return (f"B1 tiers: {tuple(x.shape)} waveforms, 64 mel bands",
            timed, outputs)


def kmeans_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for the centroid sums
    at one default clustering batch (17.23M unit rows x 64, K 500, the ids
    of a Lloyd assignment to 500 of the rows), each tier."""
    import torch

    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin_plain

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    n, k = 10_000 * (1 + 220_500 // 128), 500
    x = torch.randn((n, 64), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10
    cents = x[torch.randperm(n, generator=g, device=dev)[:k]]
    ids = vq_argmin_plain(x, cents, False, chunk=1 << 18)  # Lloyd's ids
    tiers = ("highest", "bf16x3", "default")

    def outputs():
        return tuple(tier_sums64(x, ids, k, t) for t in tiers)

    timed = {t: (lambda t=t: tier_sums64(x, ids, k, t)) for t in tiers}
    return (f"centroid sums: {n} x 64 rows, K {k}, sort included", timed,
            outputs)


def synthetic_clips(n: int, sr: int = 22050, seconds: float = 10.0):
    """bench.py's synthetic clips: two partials plus noise, seeded."""
    import numpy as np

    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    return [(0.5 * np.sin(2 * np.pi * 80.0 * (1 + i % 16) * t)
             + 0.2 * np.sin(2 * np.pi * 2.3 * 80.0 * (1 + i % 16) * t)
             + 0.1 * rng.standard_normal(len(t))).astype(np.float32)
            for i in range(n)]


def tokenizer_case(gen):
    """-> (description, {timed name: fn}, outputs fn) for kernel B1."""
    import numpy as np
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    rng = np.random.default_rng(7)
    cents = rng.standard_normal((500, 64)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-10
    cfg = AudioTokensConfig(clip_seconds=10.0, vocab_size=500)
    tok = FusedTokenizer(cfg, cents, torch.device("cuda", 0))
    kern, fe = tok.kernel, tok.frontend
    x = torch.from_numpy(fe.prepare_batch(synthetic_clips(64))[0]).cuda()
    ref = kern.plain(x)
    unit = l2_normalize(kern.log_mel_plain(x))

    def outputs():
        got = kern(x)
        try:
            frac, gap = check_near_ties(unit, kern.centroids, got, ref)
        except AssertionError as e:
            return (got,), f"FAILS the near-tie rule against plain: {e}"
        return (got,), (f"{frac:.2e} of tokens differ from the plain "
                        f"version, largest score gap {gap:.3e}")

    return (f"B1: {tuple(x.shape)} waveforms -> {tuple(ref.shape)} tokens, "
            f"K 500", {"B1": lambda: kern(x)}, outputs)


CASES = {"attention": attention_case, "attention-f32": attention_f32_case,
         "lstm": lstm_case,
         "lstm-dw": lstm_dw_case, "lstm-fwd": lstm_fwd_case,
         "tokenizer": tokenizer_case, "vq": vq_case, "kmeans": kmeans_case,
         "vq-tier": vq_tier_case, "tokenizer-tier": tokenizer_tier_case}


def phase_split(lib, kernel: str, fn) -> str:
    """One call of ``fn`` with the cycle counters of ``kernel`` zeroed ->
    each phase's mean cycles a step and share (a timer build only)."""
    import torch

    which = 1 if kernel == "lstm" else 0
    resident, needed = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.atk_lstm_max_blocks(
        B_LSTM, H_LSTM, which, ctypes.byref(resident), ctypes.byref(needed)),
        "lstm occupancy query")
    phases = TIMER_PHASES[kernel]
    buf = (ctypes.c_ulonglong * (needed.value * 6))()
    lib.atk_lstm_timers.argtypes = [_build.I, ctypes.c_void_p, _build.I]
    torch.cuda.synchronize()
    _build.check(lib, lib.atk_lstm_timers(which, buf, needed.value), "timers")
    fn()
    torch.cuda.synchronize()
    _build.check(lib, lib.atk_lstm_timers(which, buf, needed.value), "timers")
    steps = 2 * T_LSTM  # both directions
    sums = [sum(buf[blk * 6 + p] for blk in range(needed.value))
            / needed.value / steps for p in range(len(phases))]
    total = sum(sums)
    return ("cycles a step (thread 0, mean over blocks): "
            + ", ".join(f"{ph} {c:.0f} ({c / total:.0%})"
                        for ph, c in zip(phases, sums))
            + f"; total {total:.0f}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(DEFAULT_VARIANTS),
                    default="attention")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--source", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    reps = 2 if args.kernel.startswith("lstm") else 10  # launches a reading
    ops = __import__(f"audio_tokens_tpu_torch.ops.{MODULES[args.kernel]}",
                     fromlist=["_lib"])
    src_name = SOURCES[args.kernel]
    source = _build.CSRC / f"{src_name}.cu"
    variants = {}
    for spec in args.variant or DEFAULT_VARIANTS[args.kernel]:
        name, _, defs = spec.partition(":")
        variants[name] = (source, [d for d in defs.split(",") if d])
    variants.setdefault("default", (source, []))
    for spec in args.source:
        name, _, rest = spec.partition(":")
        path, _, defs = rest.partition(":")
        variants[name] = (Path(path), [d for d in defs.split(",") if d])
    libs = build_all(args.kernel, variants)

    def use(name: str) -> None:
        """Point the wrappers at one variant's library."""
        lib = ctypes.CDLL(str(libs[name]))
        lib.atk_error_string.argtypes = [ctypes.c_int]
        lib.atk_error_string.restype = ctypes.c_char_p
        _build._loaded[src_name] = lib
        try:
            ops._lib()
        except AttributeError:  # an earlier source lacks a newer entry point
            pass

    use("default")
    gen = torch.Generator().manual_seed(6)
    desc, timed, outputs = CASES[args.kernel](gen)
    outs, notes = {}, {}
    for name in variants:
        use(name)
        got = outputs()
        if isinstance(got[-1], str):  # (outputs, a note on their accuracy)
            got, notes[name] = got
        outs[name] = [x.clone() for x in got]
    torch.cuda.synchronize()
    times = {name: {label: [] for label in timed} for name in variants}
    for _ in range(args.rounds):
        for name in variants:
            use(name)
            for label, fn in timed.items():
                try:
                    times[name][label].append(cuda_ms(fn, reps))
                except AttributeError:  # not in an earlier source
                    pass
    splits = {}
    for name in variants:
        use(name)
        lib = _build._loaded[src_name]
        if args.kernel in TIMER_PHASES and hasattr(lib, "atk_lstm_timers"):
            splits[name] = phase_split(lib, args.kernel,
                                       next(iter(timed.values())))

    print(f"{desc}; {args.rounds} rounds in turns, {reps} launches a reading")
    for name, (src, defines) in variants.items():
        same = all(torch.equal(a, b) for a, b in zip(outs[name],
                                                     outs["default"]))
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(outs[name], outs["default"]))
        digest = hashlib.sha256(b"".join(
            x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for x in outs[name])).hexdigest()[:16]
        parts = []
        for label, ts in times[name].items():
            if ts:
                parts.append(f"{label} median {statistics.median(ts):.4f} ms "
                             f"(min {min(ts):.4f}, max {max(ts):.4f})")
        print(f"{name} ({' '.join(defines) or src.name}): "
              + "; ".join(parts)
              + f"; bit-equal to default: {same} (max abs diff {worst:.3e}); "
              + f"outputs sha256 {digest}; "
              + (notes[name] + "; " if name in notes else "")
              + ptxas_summary(libs[name].with_suffix(".log"),
                              PTXAS_KERNELS[args.kernel]))
        if name in splits:
            print(f"  {name} phases: {splits[name]}")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
