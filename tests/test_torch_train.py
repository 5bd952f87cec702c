"""The port's Trainer (streaming route) against the JAX Trainer on a
tokenized fixture corpus, under a weight transplant: per-step losses within
5e-5, then val loss within 5e-5 and val mAP within 1e-3 (f32 through a
short AdamW trajectory, sums in another order).  Also exact checkpoint
resume, the step and patience limits, the metrics history, the stage CLI,
and the options the port refuses (tensor and sequence parallelism; data
parallelism is held in ``tests/test_torch_multiprocess.py``).
These runs stream (``device_corpus="off"``); the device-resident epochs
are held to them in ``tests/test_torch_device_epoch.py``."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.datasets import DataLoaderCreator
from audio_tokens_tpu.train import trainer as jax_trainer
from audio_tokens_tpu_torch.convert import lstm_state_dict
from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer
from audio_tokens_tpu_torch.train import checkpoint as port_ckpt
from audio_tokens_tpu_torch.train import trainer as port_trainer
from tests import token_corpus

REPO = Path(__file__).resolve().parents[1]
LOSS_ATOL = 5e-5
MAP_ATOL = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("token_corpus")
    token_corpus.make_token_corpus(base)
    return base


def _record_losses(monkeypatch, module):
    """Every loss scalar a trainer's _LossMean sees, in order (the train
    steps of each epoch, then its eval batches)."""
    seen = []
    add = module._LossMean.add

    def recording_add(self, loss):
        seen.append(float(np.asarray(loss)))
        add(self, loss)

    monkeypatch.setattr(module._LossMean, "add", recording_add)
    return seen


@pytest.mark.parametrize("reference_compat", [True, False])
def test_trainer_matches_jax_trainer(corpus, tmp_path, monkeypatch,
                                     reference_compat):
    kw = dict(epochs=2, reference_compat=reference_compat,
              checkpoint_dir=str(tmp_path / "ckpt"))
    jcfg = token_corpus.config(corpus, **kw)
    jt = jax_trainer.Trainer(jcfg)
    train_loader, _ = DataLoaderCreator(jcfg).get_dataloaders()
    params, _ = jt._init_state(train_loader)  # what run() initializes
    pt = port_trainer.Trainer(token_corpus.port_config(corpus, **kw), "cpu")
    pt.model.load_state_dict(lstm_state_dict(jax.device_get(params)))

    jax_losses = _record_losses(monkeypatch, jax_trainer)
    j_loss, j_metrics = jt.run()
    port_losses = _record_losses(monkeypatch, port_trainer)
    p_loss, p_metrics = pt.run()

    # 2 epochs x (5 train steps, the last on 2 real rows + 2 eval batches)
    assert len(port_losses) == len(jax_losses) == 14
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL,
                               rtol=0)
    assert abs(p_loss - j_loss) <= LOSS_ATOL
    assert abs(p_metrics["mAP"] - j_metrics["mAP"]) <= MAP_ATOL
    assert port_losses[5] != port_losses[0]  # the weights moved
    history = (tmp_path / "ckpt" / "no-wandb-metrics.jsonl").read_text()
    assert len(history.splitlines()) == 2 * 2  # both trainers, 2 epochs


def _final_state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_resume_equals_straight_run(corpus, tmp_path):
    """2 epochs straight == 1 epoch, checkpoint, resume, 1 more epoch:
    params, optimizer moments, step and validation numbers."""
    def cfg(name, **kw):
        return token_corpus.port_config(
            corpus, checkpoint_dir=str(tmp_path / name),
            save_best_checkpoint=True, **kw)

    straight = port_trainer.Trainer(cfg("a", epochs=2), "cpu")
    s_loss, s_metrics = straight.run()
    first = port_trainer.Trainer(cfg("b", epochs=1), "cpu")
    first.run()
    meta = port_ckpt.load_meta(tmp_path / "b", "no-wandb-best")
    assert (meta["step"], meta["epoch"]) == (5, 1)
    resumed = port_trainer.Trainer(
        cfg("b", epochs=2, resume_from="no-wandb-best"), "cpu")
    r_loss, r_metrics = resumed.run()
    assert (r_loss, r_metrics) == (s_loss, s_metrics)
    a, b = _final_state(straight), _final_state(resumed)
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=0, rtol=0, msg=k)
    sa = straight.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sb[i][key], sa[i][key], atol=0,
                                       rtol=0)
    # leftovers of the atomic swap are gone
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "no-wandb-best", "no-wandb-metrics.jsonl"]
    assert sorted(p.name for p in (tmp_path / "b" / "no-wandb-best")
                  .iterdir()) == ["meta.json", "opt_state.pt", "params.pt"]
    # evaluate() reloads the best checkpoint into a fresh model
    fresh = port_trainer.Trainer(cfg("b", epochs=2), "cpu")
    e_loss, e_metrics = fresh.evaluate("no-wandb-best")
    assert (e_loss, e_metrics) == (r_loss, r_metrics)


def test_max_train_steps_and_early_stopping(corpus, tmp_path, monkeypatch):
    losses = _record_losses(monkeypatch, port_trainer)
    capped = port_trainer.Trainer(token_corpus.port_config(
        corpus, epochs=3, max_train_steps=7, save_best_checkpoint=True,
        checkpoint_dir=str(tmp_path / "cap")), "cpu")
    capped.run()
    # epoch 0: 5 steps + 2 eval; epoch 1: 2 steps (the cap) + 2 eval
    assert len(losses) == 11
    assert port_ckpt.load_meta(tmp_path / "cap", "no-wandb-best")["step"] \
        in (5, 7)
    losses.clear()
    stuck = port_trainer.Trainer(token_corpus.port_config(
        corpus, epochs=5, learning_rate=0.0, early_stopping_patience=1,
        checkpoint_dir=str(tmp_path / "stop")), "cpu")
    stuck.run()  # lr 0: epoch 1 cannot beat epoch 0, patience 1 stops it
    lines = (tmp_path / "stop" / "no-wandb-metrics.jsonl").read_text()
    assert [json.loads(x)["epoch"] for x in lines.splitlines()] == [0, 1]


def test_dropout_is_seeded_per_step(corpus, tmp_path):
    """With dropout, two runs of one config train the same weights."""
    def run():
        t = port_trainer.Trainer(token_corpus.port_config(
            corpus, epochs=1, dropout=0.5, max_train_steps=3,
            checkpoint_dir=str(tmp_path)), "cpu")
        t.run()
        return _final_state(t)

    a, b = run(), run()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("override", [
    {"model_parallel": 2, "lstm_backend": "pallas"},
    {"sequence_parallel": 2},
])
def test_unported_training_options_refused(tmp_path, override):
    """The lstm under tensor or sequence parallelism: refused by the port
    as by the JAX trainer (the port's lstm always runs its kernels, as the
    JAX Pallas backend, which takes no model axis)."""
    match = ("DP-only mesh" if "model_parallel" in override
             else "applies to the transformer only")
    with pytest.raises(ValueError, match=match):
        jax_trainer.Trainer(token_corpus.config(tmp_path, **override))
    cfg = token_corpus.port_config(tmp_path, **override)
    with pytest.raises(ValueError, match=match):
        port_trainer.Trainer(cfg, "cpu")


def test_bad_device_corpus_value_refused(tmp_path):
    with pytest.raises(ValueError, match="device_corpus"):
        port_trainer.Trainer(
            token_corpus.port_config(tmp_path, device_corpus="maybe"), "cpu")


def test_model_trainer_defaults_to_the_card_and_fails_without_one(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0"):
        ModelTrainer(token_corpus.port_config(tmp_path))


def test_model_trainer_cli_on_cpu(corpus, tmp_path):
    """``python -m audio_tokens_tpu_torch.processors.model_trainer`` with
    config flags and ``--device cpu`` trains and reports."""
    cmd = [sys.executable, "-m",
           "audio_tokens_tpu_torch.processors.model_trainer",
           "--device", "cpu", "--base_dir", str(corpus),
           "--checkpoint_dir", str(tmp_path), "--epochs", "1",
           "--num_classes", "7", "--vocab_size", "16", "--max_seq_len", "64",
           "--training_batch_size", "4", "--lstm_embed_dim", "16",
           "--lstm_hidden_dim", "24", "--num_workers", "1",
           "--validation_ratio", "0.25"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Final Validation mAP" in out.stderr
    assert (tmp_path / "no-wandb-best" / "params.pt").exists()
