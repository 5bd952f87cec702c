"""A/B the tuning knobs of kernel B5's bf16 backward pair on one card.

    python -m audio_tokens_tpu_torch.tools.flash_bwd_ab [--rounds 5]
        [--variant NAME:KEY=VAL,KEY=VAL ...] [--source NAME:path/attention.cu]

Each variant is ``csrc/attention.cu`` compiled with other values of its
``ATK_*`` knobs (``ATK_DKV_WARPS``, ``ATK_DKV_BLOCKS``, ``ATK_DQ_WARPS``,
``ATK_DQ_BLOCKS``, ``ATK_BWD_STAGES``, ``ATK_BWD_UNROLL``,
``ATK_BWD_SKIP``, ``ATK_BWD_PLAIN_TILES``) into ``build/kernels/ab/``; ``--source``
adds another file with the same C interface (an earlier commit's kernels,
say) under a name.  All are built in parallel, then timed in turns, round
after round, on the shapes ``chip_smoke.py`` uses for ``[B5 backward]``:
(8, 12, 1728, 64) bf16, random prefix lengths with a 0.  Per variant the
script prints ptxas' registers and spills of the two kernels, the median
and the spread of the dk/dv and dq times over the rounds (CUDA events, 10
launches a reading), and whether its outputs equal the default build's bit
for bit (they must for every knob: no knob changes a sum's order; another
source's need not), and the time of the one model-level step that reaches
the pair: a weighted-BCE loss + backward through an eval-mode forward of
the bert classifier at its full width (hidden 768, 12 heads, 2 layers,
window 1728, bf16, ``transformer_attention="flash"``; random weights and
tokens) on 4 rows.  The last line is the card as nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.ops import _build, cuda_attention
from audio_tokens_tpu_torch.train.objective import weighted_bce

SHAPE = (8, 12, 1728, 64)
SM_SCALE = 0.125
DEFAULT_VARIANTS = (
    "default:",
    "no-skip:ATK_BWD_SKIP=0",
    "mask-every-tile:ATK_BWD_PLAIN_TILES=0",
    "stages-3:ATK_BWD_STAGES=3",
    "unroll-4:ATK_BWD_UNROLL=4",
    "dkv-2-blocks:ATK_DKV_BLOCKS=2",
    "dkv-8-warps:ATK_DKV_WARPS=8,ATK_DKV_BLOCKS=1",
    "dq-4-warps:ATK_DQ_WARPS=4",
)


def build_all(variants: Dict[str, Tuple[Path, List[str]]]) -> Dict[str, Path]:
    """nvcc for every (source, defines), all started together."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, defines) in variants.items():
        lib = out_dir / f"libattention_{name}.so"
        cmd = _build.nvcc_command("attention", lib, defines)
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


def ptxas_summary(log: Path) -> str:
    """'kernel: N registers, S spill' for the two bf16 backward kernels."""
    found, current, spill = [], None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            current = next((k for k in ("flash_dkv_mma", "flash_dq_mma",
                                        "flash_dkv_kernelI13", "flash_dq_kernelI13")
                            if k in line), None)
        elif current and "spill stores" in line:
            spill = line.strip()
        elif current and "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            found.append(f"{current}: {regs}, {spill}")
            current = None
    return "; ".join(found)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--source", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1

    variants = {}
    for spec in args.variant or DEFAULT_VARIANTS:
        name, _, defs = spec.partition(":")
        variants[name] = (_build.CSRC / "attention.cu",
                          [d for d in defs.split(",") if d])
    variants.setdefault("default", (_build.CSRC / "attention.cu", []))
    for spec in args.source:
        name, _, path = spec.partition(":")
        variants[name] = (Path(path), [])
    libs = build_all(variants)

    gen = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(SHAPE, generator=gen).to("cuda", torch.bfloat16)
                   for _ in range(4))
    t = SHAPE[2]
    lens = torch.randint(1, t + 1, (SHAPE[0],), generator=gen)
    lens[0] = 0
    seg = (torch.arange(t)[None, :] >= lens[:, None]).to(torch.int32).cuda()
    o, lse = cuda_attention.flash_attention_fwd(q, k, v, seg, SM_SCALE, True)
    di = (o.float() * do.float()).sum(-1)
    call = (q, k, v, seg, lse, do, di, SM_SCALE)

    def use(name: str) -> None:
        """Point the wrappers at one variant's library."""
        lib = ctypes.CDLL(str(libs[name]))
        lib.atk_error_string.argtypes = [ctypes.c_int]
        lib.atk_error_string.restype = ctypes.c_char_p
        _build._loaded["attention"] = lib

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 10

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

    outs, times = {}, {name: ([], [], []) for name in variants}
    for name in variants:
        use(name)
        outs[name] = (*cuda_attention.flash_attention_bwd_dkv(*call),
                      cuda_attention.flash_attention_bwd_dq(*call))
    torch.cuda.synchronize()
    for _ in range(args.rounds):
        for name in variants:
            use(name)
            times[name][0].append(
                ms(lambda: cuda_attention.flash_attention_bwd_dkv(*call)))
            times[name][1].append(
                ms(lambda: cuda_attention.flash_attention_bwd_dq(*call)))
            times[name][2].append(ms(model_step))

    print(f"B5 backward, bf16 {SHAPE}, prefix lengths {lens.tolist()}, "
          f"{args.rounds} rounds in turns, 10 launches a reading")
    for name, (source, defines) in variants.items():
        dkv, dq, step = times[name]
        same = all(torch.equal(a, b) for a, b in zip(outs[name],
                                                     outs["default"]))
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(outs[name], outs["default"]))
        print(f"{name} ({' '.join(defines) or source.name}): dk/dv median "
              f"{statistics.median(dkv):.4f} ms (min {min(dkv):.4f}, max "
              f"{max(dkv):.4f}), dq median {statistics.median(dq):.4f} ms "
              f"(min {min(dq):.4f}, max {max(dq):.4f}), pair "
              f"{statistics.median(dkv) + statistics.median(dq):.4f} ms; "
              f"bert eval-mode loss + backward on 4 rows median "
              f"{statistics.median(step):.3f} ms (min {min(step):.3f}, max "
              f"{max(step):.3f}); "
              f"bit-equal to default: {same} (max abs diff {worst:.3e}); "
              f"{ptxas_summary(libs[name].with_suffix('.log'))}")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
