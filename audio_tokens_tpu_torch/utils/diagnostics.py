"""Model diagnostics: gradient-flow report and loss-landscape grid
(counterpart of ``audio_tokens_tpu/utils/diagnostics.py``).

Equivalent of the reference's ModelDiagnostics (model_diagnostics.py:8-99),
which was wired in but disabled and crashed on the current batch format.
Both diagnostics are functions of (params, batch): ``loss_fn(params)``
evaluates the model on a fixed batch with a dict of parameter tensors
(``torch.func.functional_call``), as the JAX functions take a params tree.

  * ``gradient_flow``  — per-parameter mean/max |grad| (and a bar chart),
    from one backward and one copy of every statistic to the host;
  * ``loss_landscape`` — the loss on a grid spanned by two random
    filter-normalized directions in parameter space (Li et al. 2018 style),
    drawn from an explicit ``torch.Generator``.

The charts need ``matplotlib``; where it does not import, the report is
logged and the chart skipped with a warning, as in the JAX package.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from audio_tokens_tpu_torch.train.objective import model_inputs, weighted_bce

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


def gradient_flow(loss_fn: Callable[[Params], torch.Tensor], params: Params,
                  plot_path: Optional[Path] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Per-parameter mean and max absolute gradient (reference :52-99),
    keyed by parameter name: one backward, then every statistic stacked on
    the device and copied to the host at once."""
    names = list(params)
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    with torch.enable_grad():
        loss = loss_fn(dict(zip(names, leaves)))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    stats = torch.stack([
        torch.stack([g.abs().mean(), g.abs().max()]) if g is not None
        else torch.zeros(2, device=loss.device) for g in grads]).cpu()
    report = {n: {"mean_abs_grad": float(s[0]), "max_abs_grad": float(s[1])}
              for n, s in zip(names, stats)}
    for name, r in report.items():
        logger.info("grad %-50s mean=%.3e max=%.3e",
                    name, r["mean_abs_grad"], r["max_abs_grad"])
    if plot_path is not None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            means = [report[n]["mean_abs_grad"] for n in names]
            maxes = [report[n]["max_abs_grad"] for n in names]
            fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.5), 6))
            xs = np.arange(len(names))
            ax.bar(xs - 0.2, means, 0.4, label="mean |grad|")
            ax.bar(xs + 0.2, maxes, 0.4, label="max |grad|")
            ax.set_yscale("log")
            ax.set_xticks(xs)
            ax.set_xticklabels(names, rotation=90, fontsize=6)
            ax.legend()
            fig.tight_layout()
            Path(plot_path).parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(plot_path)
            plt.close(fig)
        except Exception as e:
            logger.warning("gradient flow plot failed: %s", e)
    return report


def loss_landscape(loss_fn: Callable[[Params], torch.Tensor], params: Params,
                   generator: torch.Generator, span: float = 1.0,
                   steps: int = 20, plot_path: Optional[Path] = None
                   ) -> np.ndarray:
    """(steps, steps) loss grid over two filter-normalized random directions
    drawn from ``generator`` (on the parameters' device), every point queued
    on the device and the grid copied to the host once."""

    def rand_dir() -> Params:
        out = {}
        for name, w in params.items():
            d = torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=w.dtype)
            # filter-normalize: the parameter's norm, so scales compare
            out[name] = d * (w.norm() / (d.norm() + 1e-10))
        return out

    d1, d2 = rand_dir(), rand_dir()
    alphas = np.linspace(-span, span, steps)
    with torch.no_grad():
        grid = torch.stack([torch.stack([
            loss_fn({n: w + a * d1[n] + b * d2[n]
                     for n, w in params.items()}).float()
            for b in alphas]) for a in alphas]).cpu().numpy()
    if plot_path is not None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 7))
            c = ax.contourf(alphas, alphas, grid.T, levels=30)
            fig.colorbar(c)
            ax.set_title("Loss landscape")
            Path(plot_path).parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(plot_path)
            plt.close(fig)
        except Exception as e:
            logger.warning("loss landscape plot failed: %s", e)
    return grid


def make_batch_loss(model: torch.nn.Module, batch, use_lengths: bool,
                    device: torch.device | str
                    ) -> Callable[[Params], torch.Tensor]:
    """loss_fn(params) on one fixed ``BatchLoader`` batch: the weighted BCE
    of the model in eval mode (no dropout, as the JAX diagnostics'
    ``deterministic=True``) called with ``params`` in place of its own."""
    inputs = model_inputs(torch.from_numpy(batch["inputs"]).to(device))
    labels = torch.from_numpy(batch["labels"]).to(device)
    lengths = (torch.from_numpy(batch["lengths"]).to(device) if use_lengths
               else None)
    row_w = torch.from_numpy(
        (np.arange(len(batch["lengths"])) < batch["n_valid"]).astype(
            np.float32)).to(device)

    def loss_fn(params: Params) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            logits = torch.func.functional_call(model, params,
                                                (inputs, lengths))
        finally:
            model.train(was_training)
        return weighted_bce(logits, labels, row_w)

    return loss_fn
