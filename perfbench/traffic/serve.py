"""Serving traffic: batches of clips handed to ``ServingProgram.serve`` at a
fixed rate (an open loop).

The inputs are what a caller holds: float32 waveform rows in host memory
(pageable), each clip centered in ``n_fft / 2 + samples + n_fft / 2``
samples with reflection at both ends, and the clips' sample counts.  A
clip is two partials plus noise, as ``chip_smoke.make_clips`` makes them,
at a fundamental drawn from the seed; ``short_per_batch`` clips of a batch
are cut to a length between ``short_seconds`` and the full clip (zeros
past the reflection).  ``pool`` distinct batches are made once; request k
sends batch k mod pool.  Every seed gets the same sizes.

Request k is due ``k / rate`` seconds after the window opens, the same
times for every seed.  One client sends it when it is due, or as soon as
the request before it has been read back if that ends later, and reads its
tokens and probabilities back to the host at once; a request's latency
runs from when it was due to the end of its read, so a late send counts.
No request is sent once the window has closed.  The rate is fixed in the
traffic file: at about four fifths of the highest rate the cell sustains
on the card, where the tail of the latencies is judged, or far above it,
where the clips completed a second are (PERF.md).

``correct`` (after the window, the program freed): for ``check_requests``
requests drawn from the seed, one of each of as many distinct batches,
the reference recomputes the log-mel frames in float64 and the served
tokens' distance gap to the nearest centroid (``token_gap``), the frame
counts (``n_valid_mismatch``), and the classifier's probabilities on the
served tokens (``probs_gap``, the largest absolute difference).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.reference import bert as ref_bert
from perfbench.reference import lstm as ref_lstm
from perfbench.reference.frontend import Frontend, nearest, token_gap

def make_pool(cfg: dict, mix: dict, seed: int, device: torch.device):
    """-> (rows: list of (B, padded) f32 host tensors, lengths: list of
    (B,) int32 host tensors)."""
    sr, n_fft = cfg["common_sr"], cfg["n_fft"]
    samples = int(sr * cfg["clip_seconds"])
    pad, b = n_fft // 2, mix["batch"]
    gen = inputs.generator(seed, "traffic", device)
    t = torch.arange(samples, dtype=torch.float64, device=device) / sr
    rows, lengths = [], []
    for _ in range(mix["pool"]):
        f0 = 80.0 * (1 + torch.randint(0, 16, (b, 1), generator=gen,
                                       device=device)).double()
        x = (0.5 * torch.sin(2 * math.pi * f0 * t)
             + 0.2 * torch.sin(2 * math.pi * 2.3 * f0 * t)
             + 0.1 * torch.randn((b, samples), generator=gen, device=device,
                                 dtype=torch.float64)).float()
        n = torch.full((b,), samples, dtype=torch.int64, device=device)
        short = torch.randperm(b, generator=gen, device=device)[
            :mix["short_per_batch"]]
        lo = int(mix["short_seconds"] * sr)
        n[short] = torch.randint(lo, samples, (len(short),), generator=gen,
                                 device=device)
        out = torch.zeros((b, samples + 2 * pad), device=device)
        for i, m in enumerate(n.tolist()):
            out[i, pad:pad + m] = x[i, :m]
            out[i, :pad] = x[i, 1:pad + 1].flip(0)
            out[i, pad + m:pad + m + pad] = x[i, m - pad - 1:m - 1].flip(0)
        rows.append(out.cpu())
        lengths.append(n.to(torch.int32).cpu())
    return rows, lengths


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, spans):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from audio_tokens_tpu_torch.export import ServingProgram
        from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

        cfg, dev = self.cfg, self.device
        clock = program.Clock()
        acfg = program.config(cfg, self.seed)
        self.weights = inputs.make_weights(cfg, self.seed, dev)
        self.centroids = inputs.unit_centroids(
            cfg["vocab_size"], cfg["n_mels"], self.seed, dev)
        self.rows, self.lengths = make_pool(cfg, self.mix, self.seed, dev)
        clock.lap("inputs")
        tokenizer = FusedTokenizer(acfg, self.centroids.cpu().numpy(), dev)
        self.program = ServingProgram.from_components(
            acfg, tokenizer, state_dict=self.weights, device=dev)
        clock.lap("program")
        self.loop(requests=1)
        clock.lap("first request")
        self.loop(requests=self.mix["warm_requests"])
        self.split = clock.lap("warm-up")

    # -- the window ----------------------------------------------------------
    def loop(self, deadline: float = None, requests: int = None,
             rate: float = None) -> dict:
        """Requests due every 1 / ``rate`` seconds from the start (back to
        back without a rate), until the next one would be due at
        ``deadline`` or the clock has reached it, or for ``requests``.
        Each is handed to ``serve`` when it is due, or as soon as the one
        before it has been read back, and read back at once; its latency
        runs from when it was due."""
        done = []
        k = 0
        start = time.perf_counter()
        while requests is None or k < requests:
            now = time.perf_counter()
            due = now if rate is None else start + k / rate
            if deadline is not None and max(now, due) >= deadline:
                break
            if now < due:
                with self.spans.span("wait"):
                    time.sleep(due - now)
            i = k % len(self.rows)
            with self.spans.span("serve"):
                out = self.program.serve(self.rows[i], self.lengths[i])
            with self.spans.span("read"):
                host = tuple(o.cpu() for o in out)
            # (request, batch, latency, its tokens, n_valid and probs)
            done.append((k, i, time.perf_counter() - due, host))
            k += 1
        return {"attempted": k, "done": done,
                "seconds": time.perf_counter() - start}

    def window(self, seconds: float) -> dict:
        return self.loop(deadline=time.perf_counter() + seconds,
                         rate=self.mix["rate"])

    @staticmethod
    def units(stats: dict) -> int:
        return len(stats["done"])

    def end_to_end(self, stats: dict) -> Dict[str, float]:
        lat = [d[2] for d in stats["done"]]
        return {"serve_clips_per_s":
                self.mix["batch"] * len(lat) / stats["seconds"],
                "request_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def release(self) -> None:
        del self.program
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct -------------------------------------------------------------
    def sample(self, stats: dict) -> List[tuple]:
        """``check_requests`` finished requests of distinct batches, drawn
        from the seed."""
        by_batch: Dict[int, list] = {}
        for d in stats["done"]:
            by_batch.setdefault(d[1], []).append(d)
        rng = np.random.default_rng(self.seed)
        batches = sorted(by_batch)
        picked = rng.choice(len(batches), min(self.mix["check_requests"],
                                              len(batches)), replace=False)
        return [by_batch[batches[j]][rng.integers(len(by_batch[batches[j]]))]
                for j in sorted(picked)]

    def check(self, stats: dict) -> Dict[str, float]:
        sides = [(d[1], d[3]) for d in self.sample(stats)]
        return self.judge(sides)

    def judge(self, sides) -> Dict[str, float]:
        """The numbers compared, over ``sides``: (batch index, (tokens,
        n_valid, probs)) as a served side returned them."""
        cfg, dev = self.cfg, self.device
        front = Frontend(cfg, dev)
        w = {k: v.double() for k, v in self.weights.items()}
        gaps = {"token_gap": 0.0, "probs_gap": 0.0, "n_valid_mismatch": 0.0}
        for i, (tokens, n_valid, probs) in sides:
            rows = self.rows[i].to(dev)
            feats = front.features(rows, "float64")
            tokens = tokens.to(dev)
            gaps["token_gap"] = max(gaps["token_gap"],
                                    token_gap(feats, self.centroids, tokens))
            want = 1 + self.lengths[i].long() // cfg["hop_length"]
            gaps["n_valid_mismatch"] += float(
                (n_valid.long() != want).sum())
            ref = torch.sigmoid(self._logits(tokens, want.to(dev), w,
                                             "float64"))
            gaps["probs_gap"] = max(gaps["probs_gap"], float(
                (probs.to(dev).double() - ref).abs().max()))
        return gaps

    def classifier_input(self, tokens, n_valid):
        """The classifier's (B, T) tokens: the clip's frames, zero past
        them and past the window (the served model's pad token)."""
        t = self.cfg["max_seq_len"]
        x = torch.zeros((tokens.shape[0], t), dtype=torch.long,
                        device=tokens.device)
        m = min(t, tokens.shape[1])
        x[:, :m] = tokens[:, :m]
        pos = torch.arange(t, device=tokens.device)[None, :]
        return torch.where(pos < n_valid.clamp(max=t)[:, None], x, 0)

    def _logits(self, tokens, n_valid, w, precision):
        cfg = self.cfg
        x = self.classifier_input(tokens, n_valid)
        if cfg["model_type"] == "lstm":
            return ref_lstm.logits(x, w, cfg["num_layers"], precision)
        return ref_bert.logits(x, w, cfg["num_layers"],
                               cfg["transformer_max_position"], precision)

    def control_side(self, i: int):
        """The reference one precision step below the configuration's, in
        the program's place: (tokens, n_valid, probs) of batch ``i``."""
        cfg, dev = self.cfg, self.device
        prec = cfg["precision"]
        front_p = program.STEP_DOWN[prec["frontend"]]
        cls_p = program.STEP_DOWN[prec["classifier"]]
        rows = self.rows[i].to(dev)
        tokens = nearest(Frontend(cfg, dev).features(rows, front_p),
                         self.centroids, front_p)
        n_valid = 1 + self.lengths[i].long().to(dev) // cfg["hop_length"]
        w = {k: v.float() for k, v in self.weights.items()}
        probs = torch.sigmoid(self._logits(tokens, n_valid, w, cls_p))
        return tokens.cpu(), n_valid.cpu(), probs.float().cpu()

