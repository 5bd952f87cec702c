"""The port's model diagnostics (``utils/diagnostics.py``) on the CPU: the
gradient-flow report against the JAX package's ``gradient_flow`` under a
``convert.state_dict_for`` weight transplant (each parameter's mean and max
|grad| within rel 1e-4 / abs 1e-9), the loss landscape's grid, and the
trainer's ``diagnostics_every`` hook (its chart beside the checkpoints, or a
warning where matplotlib does not import)."""

import logging
import sys

import jax
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.datasets import DataLoaderCreator as JaxLoaders
from audio_tokens_tpu.models import get_model as jax_model
from audio_tokens_tpu.utils import diagnostics as jax_diag
from audio_tokens_tpu.utils.seeding import key_for
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import state_dict_for
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.train.trainer import Trainer
from audio_tokens_tpu_torch.utils.diagnostics import (gradient_flow,
                                                      loss_landscape,
                                                      make_batch_loss)
from tests import token_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("diagnostics_corpus")
    token_corpus.make_token_corpus(base)
    return base


def _port_names(model_type, params):
    """JAX leaf path -> port parameter name, by carrying a tree whose leaf i
    is filled with i through the family's map."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32)
                  for i, (_, x) in enumerate(flat)])
    names = {}
    for name, t in state_dict_for(model_type, marked).items():
        path = flat[int(t.reshape(-1)[0])][0]
        names["/".join(str(getattr(k, "key", k)) for k in path)] = name
    return names


@pytest.mark.parametrize("model_type", ["lstm", "simple"])
def test_gradient_flow_matches_jax(corpus, model_type):
    cfg = token_corpus.config(corpus, model_type=model_type)
    batch = next(iter(JaxLoaders(cfg).get_dataloaders()[0].batches(0)))
    jm = jax_model(cfg)
    params = jm.init(key_for(0, "model_init"), batch["inputs"],
                     lengths=batch["lengths"])["params"]
    want = jax_diag.gradient_flow(
        jax_diag.make_batch_loss(jm, batch, True), params)
    pm = get_model(AudioTokensConfig(**cfg.to_dict()), "cpu",
                   torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_for(model_type, jax.device_get(params)))
    got = gradient_flow(make_batch_loss(pm, batch, True, "cpu"),
                        dict(pm.named_parameters()))
    names = _port_names(model_type, params)
    assert sorted(names.values()) == sorted(got)
    for jax_name, port_name in names.items():
        for key in ("mean_abs_grad", "max_abs_grad"):
            assert got[port_name][key] == pytest.approx(
                want[jax_name][key], rel=1e-4, abs=1e-9), (port_name, key)


def test_loss_landscape_grid(corpus):
    """An odd grid's centre is the loss at the parameters themselves; the
    directions come from the generator (same seed, same grid)."""
    cfg = AudioTokensConfig(**token_corpus.config(
        corpus, model_type="simple").to_dict())
    from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator

    batch = next(iter(DataLoaderCreator(cfg).get_dataloaders()[0].batches(0)))
    pm = get_model(cfg, "cpu", torch.Generator().manual_seed(0))
    loss_fn = make_batch_loss(pm, batch, True, "cpu")
    params = {n: p.detach() for n, p in pm.named_parameters()}
    grids = [loss_landscape(loss_fn, params, torch.Generator().manual_seed(3),
                            span=0.5, steps=3) for _ in range(2)]
    assert grids[0].shape == (3, 3) and np.isfinite(grids[0]).all()
    np.testing.assert_array_equal(grids[0], grids[1])
    assert grids[0][1, 1] == pytest.approx(float(loss_fn(params)), abs=1e-7)


def test_diagnostics_hook_writes_the_chart(corpus, tmp_path, monkeypatch):
    """``diagnostics_every=2`` over 3 epochs reports epochs 0 and 2 on their
    first batch, the chart named ``{run}-gradflow-e{epoch}.png``."""
    from audio_tokens_tpu_torch.utils import diagnostics

    seen = []
    real = diagnostics.gradient_flow

    def spy(loss_fn, params, plot_path=None):
        seen.append(plot_path.name)
        return real(loss_fn, params, plot_path=None)

    monkeypatch.setattr(diagnostics, "gradient_flow", spy)
    Trainer(token_corpus.port_config(
        corpus, epochs=3, diagnostics_every=2,
        checkpoint_dir=str(tmp_path)), "cpu").run()
    assert seen == ["no-wandb-gradflow-e0.png", "no-wandb-gradflow-e2.png"]


def test_diagnostics_without_matplotlib_warn(corpus, tmp_path, monkeypatch,
                                             caplog):
    """Where matplotlib does not import (the card's machine has none), the
    report is still made and the chart is skipped with a warning."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.WARNING,
                         logger="audio_tokens_tpu_torch.utils.diagnostics"):
        Trainer(token_corpus.port_config(
            corpus, epochs=1, diagnostics_every=1,
            checkpoint_dir=str(tmp_path)), "cpu").run()
    assert any("gradient flow plot failed" in r.message
               for r in caplog.records)
    assert not (tmp_path / "no-wandb-gradflow-e0.png").exists()
