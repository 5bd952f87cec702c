"""Clustering traffic: K-means fits of the vocabulary build
(``ops/kmeans.py::kmeans_fit``, in memory) over one clustering batch of
frames resident on the card.

The frames are ``clips`` x ``frames_per_clip`` rows of ``n_mels``, made on
the card and L2-normalized, as the clustering stage hands log-mel frames
to the fit (``processors/cluster_creator.py``): draws of a mixture of
``mixture`` Gaussian components in dB (centers ``center_db`` +-
``center_spread``, spread ``spread`` a dimension, so that neighbouring
components overlap and every boundary holds rows) with Zipf(1) weights,
the skew of the assignment that the sums' sort and passes see.  The
components and the first fit's start, ``vocab_size`` draws of the same
mixture (the frames of an earlier batch of the same sound, as a random
init takes rows), are the same for every seed; the seed draws the rows.
The set-up runs the first fit; the window then runs fits of ``niter``
Lloyd iterations back to back, each from the last one's centroids, as the
``batch_warm_start`` mode refines from one clustering batch to the next.

``correct`` (after the window): one Lloyd iteration at a time, since an
iteration hands its successor its own centroids and a row that float32
scores put across a near tie moves the later iterations apart.  For the
set-up's fit and one window fit drawn from the seed, the fit's first
iteration (the program from the fit's start, ``niter`` 1) and its last
(the fit's own centroids, against one iteration from the program's
centroids after ``niter`` - 1) are held to one float64 iteration from the
same centroids (``reference/kmeans.step``): ``centroid_gap``, the largest
distance of a centroid from the reference's beyond what the rows tied
within float32 round-off can move it, over the median reference
centroid's norm, and ``objective_gap``, the objective's relative gap.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.reference.kmeans import step

BLOCK = 1 << 20


def _draws(mix: dict, centers: torch.Tensor, cdf: torch.Tensor,
           gen: torch.Generator, out: torch.Tensor) -> torch.Tensor:
    """L2-normalized draws of the mixture into every row of ``out``, in
    blocks."""
    n, d = out.shape
    for i in range(0, n, BLOCK):
        m = min(BLOCK, n - i)
        u = torch.rand(m, generator=gen, device=out.device)
        idx = torch.searchsorted(cdf, u).clamp_(max=mix["mixture"] - 1)
        x = centers[idx] + mix["spread"] * torch.randn(
            (m, d), generator=gen, device=out.device)
        out[i:i + m] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def make_frames(cfg: dict, mix: dict, seed: int, device: torch.device):
    """-> (rows (N, d) f32, the first fit's start (K, d) f32)."""
    n, d, k = mix["clips"] * mix["frames_per_clip"], cfg["n_mels"], cfg[
        "vocab_size"]
    fixed = inputs.generator(0, "traffic", device)
    centers = mix["center_db"] + mix["center_spread"] * torch.randn(
        (mix["mixture"], d), generator=fixed, device=device)
    weights = 1.0 / torch.arange(1, mix["mixture"] + 1, device=device,
                                 dtype=torch.float64)
    cdf = (weights.cumsum(0) / weights.sum()).float()
    start = _draws(mix, centers, cdf, inputs.generator(0, "init", device),
                   torch.empty((k, d), device=device))
    x = _draws(mix, centers, cdf, inputs.generator(seed, "traffic", device),
               torch.empty((n, d), device=device))
    return x, start


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, spans):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans

    def setup(self) -> None:
        from audio_tokens_tpu_torch.ops.kmeans import kmeans_fit

        self.fit_fn = kmeans_fit
        clock = program.Clock()
        self.x, self.c0 = make_frames(self.cfg, self.mix, self.seed,
                                      self.device)
        clock.lap("inputs")
        self.first = (self.c0,) + self.fit(self.c0)
        self.current = self.first[1]
        self.split = clock.lap("first fit")

    def fit(self, start: torch.Tensor):
        with self.spans.span("kmeans_fit"):
            return self.fit_fn(self.x, self.cfg["vocab_size"],
                               self.mix["niter"], init_centroids=start,
                               precision=self.cfg["kmeans_precision"])

    def window(self, seconds: float) -> dict:
        start = time.perf_counter()
        deadline = start + seconds
        fits = []
        while time.perf_counter() < deadline:
            c, obj = self.fit(self.current)
            fits.append((self.current, c, obj))
            self.current = c
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"attempted": len(fits), "done": len(fits), "fits": fits,
                "seconds": time.perf_counter() - start}

    @staticmethod
    def units(stats: dict) -> int:
        return stats["done"]

    def end_to_end(self, stats: dict) -> Dict[str, float]:
        rows = self.x.shape[0]
        return {"cluster_frames_per_s":
                rows * self.mix["niter"] * stats["done"] / stats["seconds"]}

    def release(self) -> None:
        """The fit keeps no state between calls: the cache's blocks go."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct -------------------------------------------------------------
    def sample(self, stats: dict) -> list:
        """(start, centroids, objective) of the set-up's fit and of one
        window fit drawn from the seed."""
        fits = stats["fits"]
        if not fits:
            return [self.first]
        j = int(np.random.default_rng(self.seed).integers(len(fits)))
        return [self.first, fits[j]]

    def steps(self, fits) -> list:
        """The iterations held to the reference: (centroids before, the
        program's after, its objective), the first and the last of each
        fit, the program run again to the centroids before them."""
        k, niter = self.cfg["vocab_size"], self.mix["niter"]
        prec = self.cfg["kmeans_precision"]
        out = []
        for start, c, obj in fits:
            first = self.fit_fn(self.x, k, 1, init_centroids=start,
                                precision=prec)
            out.append((start,) + tuple(first))
            before = start
            if niter > 1:
                before, _ = self.fit_fn(self.x, k, niter - 1,
                                        init_centroids=start, precision=prec)
            out.append((before, c, obj))
        return out

    def judge(self, steps) -> Dict[str, float]:
        """``steps``: (centroids before, after, objective) as a side
        returned them; each held to one float64 iteration from the same
        centroids; the worst step's numbers."""
        worst = {"centroid_gap": 0.0, "objective_gap": 0.0}
        for before, c, obj in steps:
            rc, robj, allowance = step(self.x, before, "float64")
            scale = float(torch.linalg.vector_norm(rc, dim=1).median())
            gap = torch.linalg.vector_norm(c.double() - rc, dim=1)
            beyond = float((gap - allowance).clamp_min(0.0).max()) / scale
            worst["centroid_gap"] = max(worst["centroid_gap"], beyond)
            worst["objective_gap"] = max(worst["objective_gap"],
                                         abs(float(obj) - robj) / abs(robj))
        return worst

    def check(self, stats: dict) -> Dict[str, float]:
        self.checked = self.steps(self.sample(stats))
        return self.judge(self.checked)

    def control(self) -> Dict[str, float]:
        """The reference one precision step below the configuration's in
        the program's place: each iteration that ``check`` held, from the
        same centroids."""
        prec = program.STEP_DOWN[self.cfg["precision"]["kmeans"]]
        steps = []
        for before, _, _ in self.checked:
            c, obj, _ = step(self.x, before, prec)
            steps.append((before, c, obj))
        return self.judge(steps)

    def replay_gap(self) -> Dict[str, float]:
        """Whether a fit of ``niter`` iterations is the program's last
        iteration from its centroids after ``niter`` - 1 (a reading for
        PERF.md, not compared): the largest element apart."""
        gap = 0.0
        for before, c, _ in self.checked[1::2]:
            again, _ = self.fit_fn(self.x, self.cfg["vocab_size"], 1,
                                   init_centroids=before,
                                   precision=self.cfg["kmeans_precision"])
            gap = max(gap, float((again - c).abs().max()))
        return {"replay_gap": gap}
