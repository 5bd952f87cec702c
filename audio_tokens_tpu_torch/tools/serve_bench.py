"""Sustained-serving benchmark: disk -> decode -> card tokenize, overlapped.

Counterpart of ``audio_tokens_tpu/tools/serve_bench.py``.  It measures the
whole serving loop: a host thread decodes and pads the NEXT batch while the
card tokenizes (or, with ``--classify``, tokenizes and classifies) the
current one (double buffering), so the number includes disk reads, WAV
decode, padding and the host-to-card copy.  The config's ``audio_backend``
picks the decode as in the stages (``data/native_loader``): ``auto`` (the
default, as the JAX tool) takes the native C++ decoder where it builds,
``--workers`` threads decoding a batch straight into the padded layout
(int16 under ``--wire i16``); ``--audio_backend python`` decodes with
``data/audio_io.decode_audio`` in the decode-ahead thread.  The printed
line names the decoder that ran, and the median time a batch's decode took
inside the loop (the first stage line times one warm batch alone).
``--tier`` sets both tokenizer tiers (``tokenizer_precision`` and
``tokenizer_vq_precision``; a config flag of either overrides it).  A
result is synchronized by fetching one value of the last output.

Usage: python -m audio_tokens_tpu_torch.tools.serve_bench [--n_clips 512]
       [--batch 64] [--seconds 10] [--vocab 500] [--wire f32|i16]
       [--tier highest|bf16x3|default] [--workers 8]
       [--classify MODEL_TYPE] [--latency N] [--device cuda:0]
       [<config flags>, e.g. --audio_backend python or
        --transformer_max_position 1728]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def make_corpus(base: Path, n_clips: int, seconds: float, sr: int) -> list:
    """``n_clips`` seeded 16-bit mono WAVs (a tone of 80-1280 Hz plus
    noise) under ``base``; the JAX tool's files, byte for byte."""
    from audio_tokens_tpu_torch.data.audio_io import write_pcm_wav

    rng = np.random.default_rng(0)
    paths = []
    t = np.arange(int(sr * seconds)) / sr
    for i in range(n_clips):
        f0 = 80.0 * (1 + (i % 16))
        x = (0.5 * np.sin(2 * np.pi * f0 * t)
             + 0.1 * rng.standard_normal(len(t))).astype(np.float32)
        x /= np.abs(x).max()
        p = base / f"clip{i:05d}.wav"
        write_pcm_wav(p, x, sr)
        paths.append(p)
    return paths


def _quantile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark, print its lines and return its numbers: clips/s,
    the stage times, the median decode of a batch inside the loop, and with
    ``--latency`` the request percentiles and maximum (ms)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_clips", type=int, default=512)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--vocab", type=int, default=500)
    parser.add_argument("--workers", type=int, default=8,
                        help="the native decoder's threads; the python "
                        "decode runs in the decode-ahead thread")
    parser.add_argument("--tier", default="highest",
                        choices=("highest", "bf16x3", "default"),
                        help="both tokenizer precision tiers")
    parser.add_argument("--wire", default="f32", choices=("f32", "i16"),
                        help="host->card waveform format: i16 PCM halves "
                        "the copy (exact for 16-bit sources at the target "
                        "rate)")
    parser.add_argument("--classify", default=None,
                        help="model_type: serve the whole wav->probs program "
                        "(export.ServingProgram, random-init weights) "
                        "instead of wav->tokens")
    parser.add_argument("--latency", type=int, default=0, metavar="N",
                        help="also measure single-request (batch=1) "
                        "end-to-end latency over N requests and report "
                        "p50/p90/p99")
    parser.add_argument("--device", default="cuda:0")
    # extra --field value pairs overlay the config (e.g. --audio_backend
    # python, or --transformer_max_position 1728 for full-clip bert serving)
    args, rest = parser.parse_known_args(argv)

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.data import native_loader
    from audio_tokens_tpu_torch.data.audio_io import decode_audio
    from audio_tokens_tpu_torch.ops.common import exact_f32
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    exact_f32()
    device = torch.device(args.device)
    fields = dict(clip_seconds=args.seconds, vocab_size=args.vocab,
                  tokenizer_precision=args.tier,
                  tokenizer_vq_precision=args.tier)
    if args.classify:
        fields["model_type"] = args.classify
    cfg = AudioTokensConfig(
        **{**fields, **AudioTokensConfig.parse_overrides(rest)})
    use_native = native_loader.select_backend(cfg)
    decoder = "native" if use_native else "python"
    rng = np.random.default_rng(7)
    cent = rng.standard_normal((args.vocab, cfg.n_mels)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True) + 1e-10
    tok = FusedTokenizer(cfg, cent, device)
    wire_dtype = np.int16 if args.wire == "i16" else np.float32

    def decode_batch(batch_paths, pad_to=args.batch):
        if use_native:
            batch, _ = native_loader.decode_batch(
                batch_paths, cfg.common_sr, cfg.clip_samples, cfg.n_fft,
                n_threads=args.workers, dtype=wire_dtype)
            if batch.shape[0] < pad_to:
                batch = np.pad(batch, ((0, pad_to - batch.shape[0]), (0, 0)))
            return batch
        waves = [decode_audio(p, target_sr=cfg.common_sr)[0]
                 for p in batch_paths]
        batch, _ = tok.frontend.prepare_batch(waves)
        if wire_dtype is np.int16:
            batch = np.clip(np.rint(batch * 32768.0), -32768, 32767
                            ).astype(np.int16)
        if batch.shape[0] < pad_to:
            batch = np.pad(batch, ((0, pad_to - batch.shape[0]), (0, 0)))
        return batch

    if args.classify:
        from audio_tokens_tpu_torch.export import ServingProgram

        prog = ServingProgram.from_components(cfg, tok, device=device)

        def run(host_batch):
            lengths = torch.full((host_batch.shape[0],), cfg.clip_samples,
                                 dtype=torch.int32)
            return prog(torch.from_numpy(host_batch), lengths)[2]
    else:
        def run(host_batch):
            return tok.tokens_from_padded(
                torch.from_numpy(host_batch).to(device))

    def fetch(out) -> None:
        out[0, 0].item()  # a value on the host: the card has finished

    what = (f"disk->decode->probs[{args.classify}]" if args.classify
            else "disk->decode->tokens")
    result = {"what": what, "n_clips": args.n_clips, "batch": args.batch,
              "tier": cfg.tokenizer_precision, "decoder": decoder}
    with tempfile.TemporaryDirectory(prefix="atk_serve_") as tmp:
        paths = make_corpus(Path(tmp), args.n_clips, args.seconds,
                            cfg.common_sr)
        batches = [paths[i : i + args.batch]
                   for i in range(0, len(paths), args.batch)]
        first = decode_batch(batches[0])
        fetch(run(first))  # warm both stages (first launches, page cache)

        # stage rates first, so the sustained number is attributable
        t0 = time.perf_counter()
        decode_batch(batches[0])
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fetch(run(first))
        dev_s = time.perf_counter() - t0
        mb = first.nbytes / 2**20
        print(f"stages per {args.batch}-clip batch: decode "
              f"{decode_s*1e3:.0f} ms, transfer+tokenize {dev_s*1e3:.0f} ms "
              f"({mb:.0f} MB/batch crosses the host->device link)",
              flush=True)

        loop_decode_ms = []

        def decode_in_loop(batch_paths):
            t = time.perf_counter()
            batch = decode_batch(batch_paths)
            loop_decode_ms.append((time.perf_counter() - t) * 1e3)
            return batch

        with ThreadPoolExecutor(max_workers=1) as pool:  # decode-ahead
            t0 = time.perf_counter()
            nxt = pool.submit(decode_in_loop, batches[0])
            out = None
            for i in range(len(batches)):
                host_batch = nxt.result()
                if i + 1 < len(batches):
                    nxt = pool.submit(decode_in_loop, batches[i + 1])
                out = run(host_batch)
            fetch(out)
            dt = time.perf_counter() - t0
        cps = len(paths) / dt
        loop_ms = _quantile(loop_decode_ms, 50)
        print(f"serving ({what}, double-buffered, tier={cfg.tokenizer_precision}"
              f", wire={args.wire}, {decoder} decode): {cps:.0f} clips/s over "
              f"{len(paths)} clips ({dt:.2f}s, "
              f"{len(paths) * args.seconds / dt:.0f}x realtime; decode "
              f"{loop_ms:.0f} ms a batch in the loop, median)", flush=True)
        result.update(decode_ms=decode_s * 1e3, device_ms=dev_s * 1e3,
                      decode_loop_ms=loop_ms, clips_per_s=cps, seconds=dt)

        if args.latency > 0:
            # single-request (batch=1) latency: one clip is decoded, crosses
            # the link, runs on the card and its result is fetched
            fetch(run(decode_batch(paths[:1], pad_to=1)))  # warm batch 1
            lat_ms, dec_ms = [], []
            for i in range(args.latency):
                p = paths[i % len(paths)]
                t0 = time.perf_counter()
                host_one = decode_batch([p], pad_to=1)
                t1 = time.perf_counter()
                fetch(run(host_one))  # fetch = request complete
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                dec_ms.append((t1 - t0) * 1e3)
            print(f"request latency (batch=1, {what}, n={args.latency}): "
                  f"p50 {_quantile(lat_ms, 50):.1f} ms / p90 "
                  f"{_quantile(lat_ms, 90):.1f} / p99 "
                  f"{_quantile(lat_ms, 99):.1f} (decode p50 "
                  f"{_quantile(dec_ms, 50):.1f} ms; remainder = transfer + "
                  f"device + result fetch)", flush=True)
            result.update({f"p{q}_ms": _quantile(lat_ms, q)
                           for q in (50, 90, 99)},
                          max_ms=max(lat_ms),
                          decode_p50_ms=_quantile(dec_ms, 50))
    return result


if __name__ == "__main__":
    main()
