"""Checkpoints: params (+ optimizer state + step) with a best-metric policy
(counterpart of ``audio_tokens_tpu/train/checkpoint.py``).

A checkpoint is a directory ``{checkpoint_dir}/{name}`` holding
``params.pt`` (the model's ``state_dict``), ``opt_state.pt`` (the
optimizer's ``state_dict``, when given) and ``meta.json`` with the same
keys as the JAX package's: ``step``, ``metric``, ``epoch``.  Training
resumes exactly from it; ``load_params`` serves inference.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def save_checkpoint(
    directory: str | Path,
    name: str,
    model: torch.nn.Module,
    optimizer: Optional[torch.optim.Optimizer] = None,
    step: int = 0,
    metric: float = 0.0,
    epoch: int = 0,
    extra: dict | None = None,
) -> Path:
    """``save_state`` of the model's and the optimizer's ``state_dict``."""
    return save_state(directory, name, model.state_dict(),
                      None if optimizer is None else optimizer.state_dict(),
                      step, metric, epoch, extra)


def save_state(directory: str | Path, name: str, params: dict,
               opt_state: Optional[dict] = None, step: int = 0,
               metric: float = 0.0, epoch: int = 0,
               extra: dict | None = None) -> Path:
    """Write a checkpoint of ``params`` (a state dict) and ``opt_state``
    ATOMICALLY: build under a temp name, then rename over the previous
    best.  Deleting first and saving in place would leave no loadable
    checkpoint if the process dies mid-save; meta.json is written inside
    the temp dir so a visible checkpoint always has complete metadata."""
    path = (Path(directory) / name).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    # reap scratch dirs from ANY pid — a killed run leaves its
    # checkpoint-sized `.tmp.<pid>` / `.old.<pid>` behind, and a new
    # process (new pid) would otherwise leak one per kill until the disk
    # fills.  Only this writer's name-prefix is touched.
    for stale in path.parent.glob(f"{name}.tmp.*"):
        shutil.rmtree(stale, ignore_errors=True)
    for stale in path.parent.glob(f"{name}.old.*"):
        shutil.rmtree(stale, ignore_errors=True)
    tmp = path.parent / f"{name}.tmp.{os.getpid()}"
    try:
        tmp.mkdir()
        torch.save(params, tmp / "params.pt")
        if opt_state is not None:
            torch.save(opt_state, tmp / "opt_state.pt")
        meta = {"step": step, "metric": metric, "epoch": epoch}
        if extra:
            meta.update(extra)
        (tmp / "meta.json").write_text(json.dumps(meta))
        old = path.parent / f"{name}.old.{os.getpid()}"
        if path.exists():
            os.replace(path, old)   # rename, not rmtree: O(1) swap window
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    logger.info("checkpoint saved: %s (step=%d metric=%.4f)", path, step, metric)
    return path


def load_state(directory: str | Path, name: str
               ) -> Tuple[dict, Optional[dict], dict]:
    """(params, opt_state or None, meta) of a checkpoint, on the CPU."""
    path = (Path(directory) / name).absolute()
    params = torch.load(path / "params.pt", map_location="cpu",
                        weights_only=True)
    opt_state = None
    if (path / "opt_state.pt").exists():
        opt_state = torch.load(path / "opt_state.pt", map_location="cpu",
                               weights_only=True)
    return params, opt_state, load_meta(directory, name)


def load_meta(directory: str | Path, name: str) -> dict:
    """The checkpoint's full meta.json (step/metric/epoch + any extras)."""
    path = (Path(directory) / name).absolute()
    return json.loads((path / "meta.json").read_text())


def load_params(directory: str | Path, name: str,
                model: torch.nn.Module) -> None:
    """Load the checkpoint's parameters into ``model`` (any device)."""
    path = (Path(directory) / name).absolute() / "params.pt"
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))


def load_checkpoint(
    directory: str | Path, name: str, model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
) -> Tuple[bool, int, float, int]:
    """Restore params and optimizer state in place.  Returns (whether the
    checkpoint had optimizer state, step, metric, epoch)."""
    path = (Path(directory) / name).absolute()
    meta = json.loads((path / "meta.json").read_text())
    load_params(directory, name, model)
    has_opt = (path / "opt_state.pt").exists()
    if has_opt:
        optimizer.load_state_dict(torch.load(path / "opt_state.pt",
                                             map_location="cpu",
                                             weights_only=True))
    return (has_opt, meta["step"], meta["metric"],
            int(meta.get("epoch", 0)))
