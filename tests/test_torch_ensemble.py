"""The port's ensemble / LR-sweep trainer (``train/ensemble.py``) on the
CPU: against the JAX package's ``EnsembleTrainer`` under a weight
transplant of the vmapped parameters (``convert.ensemble_state_dicts``),
per-member and ensemble numbers and weights within 1e-5 (simple with an LR
sweep, a tiny lstm against JAX's scan); then the JAX tests' properties
(JAX ``tests/test_ensemble.py``) on the port alone: member 0 is the port's
single device epoch (dropout too), lr 0 freezes a member bit for bit,
identical seeds make identical members, ``run()``'s report and
``ensemble-best`` round trip into a single model and its AdamW, a killed
run resumes bit-equal, the argument checks, remat inside an ensemble (the
counterpart of JAX ``tests/test_lstm_remat.py:85``), one read of 2K + 1
scalars an epoch, and the command line on a token corpus."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
from audio_tokens_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import ensemble_state_dicts
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.train import checkpoint as ckpt
from audio_tokens_tpu_torch.train import device_epoch
from audio_tokens_tpu_torch.train.device_epoch import DeviceEpochRunner
from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer, main
from audio_tokens_tpu_torch.train.trainer import Trainer
from tests import token_corpus

VOCAB, C, T, B, N = 50, 8, 24, 8, 32
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
LSTM = dict(model_type="lstm", lstm_embed_dim=8, lstm_hidden_dim=16,
            num_layers=1)


def _kw(tmp_path=None, **kw):
    kwargs = dict(
        model_type="simple", vocab_size=VOCAB, num_classes=C,
        max_seq_len=T, training_batch_size=B, hidden_size=32,
        random_seed=11, learning_rate=1e-3, epochs=2,
        save_best_checkpoint=False,
    )
    if tmp_path is not None:
        kwargs["base_dir"] = str(tmp_path)
    kwargs.update(kw)
    return kwargs


def _cfg(tmp_path=None, **kw):
    return AudioTokensConfig(**_kw(tmp_path, **kw))


def _corpus(rng, n=N):
    inputs = rng.integers(0, VOCAB, (n, T)).astype(np.uint16)
    lengths = rng.integers(T // 2, T + 1, n).astype(np.int32)
    labels = (rng.random((n, C)) < 0.3).astype(np.uint8)
    labels[0] = 1  # every class has at least one positive
    return inputs, lengths, labels


def _with_corpus(ens, rng):
    tr, va = _corpus(rng), _corpus(rng, n=2 * B)
    ens.set_corpus_arrays("train", *tr, n_real=N, batch_size=B)
    ens.set_corpus_arrays("validation", *va, n_real=2 * B, batch_size=B)
    return ens, tr, va


def _ensemble(cfg, rng, **kw):
    return _with_corpus(EnsembleTrainer(cfg, "cpu", **kw), rng)


def _epochs(ens, params, opt_state, epochs=2):
    """(per epoch (train losses, train mAP, train ensemble mAP, val
    losses, val mAP, val ensemble mAP), the final params)."""
    out, step = [], 0
    for epoch in range(epochs):
        params, opt_state, step, *train = ens.train_epoch(params, opt_state,
                                                          epoch, step)
        out.append((*train, *ens.eval_epoch(params)))
    return out, params


@pytest.mark.parametrize("family", ["simple", "lstm"])
def test_ensemble_matches_jax_ensemble(tmp_path, family):
    """simple as an LR sweep, and a tiny lstm (JAX's scan backend; the
    port's B3 rule on the CPU registration): the JAX ensemble's initial
    parameters carried over, two epochs on one corpus, every number and
    the final weights within 1e-5."""
    kw = _kw(tmp_path, **(LSTM if family == "lstm" else {}))
    members = dict(n_models=2) if family == "lstm" else dict(
        learning_rates=[1e-3, 3e-3])
    jens, _, _ = _with_corpus(JaxEnsemble(JaxConfig(**kw), **members),
                              np.random.default_rng(0))
    jp, jo = jens.init_state()
    ens, _, _ = _ensemble(AudioTokensConfig(**kw), np.random.default_rng(0),
                          **members)
    params, opt_state = ens.init_state()
    with torch.no_grad():
        for name, t in ensemble_state_dicts(family,
                                            jax.device_get(jp)).items():
            params[name].copy_(t)
    (want, jp), (got, params) = _epochs(jens, jp, jo), _epochs(
        ens, params, opt_state)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, **JAX_TOL)
    for name, t in ensemble_state_dicts(family, jax.device_get(jp)).items():
        torch.testing.assert_close(params[name].detach(), t, **JAX_TOL,
                                   msg=name)


def _single(cfg, tr, va):
    trainer = Trainer(cfg, "cpu")
    runner = DeviceEpochRunner(trainer)
    runner.set_corpus_arrays("train", *tr, n_real=N, batch_size=B)
    runner.set_corpus_arrays("validation", *va, n_real=2 * B, batch_size=B)
    return trainer, runner


@pytest.mark.parametrize("extra", [{}, dict(LSTM, dropout=0.1)],
                         ids=["simple", "lstm_dropout"])
def test_member_matches_single_device_epoch(tmp_path, extra):
    """Member i with seeds[i] == config.random_seed is the port's single
    Trainer device epoch (the same initial weights, dropout masks,
    permutation and AdamW); the second member diverges."""
    cfg = _cfg(tmp_path, **extra)
    ens, tr, va = _ensemble(cfg, np.random.default_rng(0),
                            seeds=[cfg.random_seed, cfg.random_seed + 5])
    params, opt_state = ens.init_state()
    trainer, runner = _single(cfg, tr, va)
    step = sstep = 0
    for epoch in range(2):
        params, opt_state, step, losses, per, _ = ens.train_epoch(
            params, opt_state, epoch, step)
        sstep, sloss, smet = runner.train_epoch(epoch, sstep)
        assert losses[0] == pytest.approx(sloss, rel=1e-5, abs=1e-6)
        assert per[0] == pytest.approx(smet["mAP"], abs=2e-6)
        assert abs(losses[1] - sloss) > 1e-7
    va_loss, va_map, _ = ens.eval_epoch(params)
    sv_loss, sv_met = runner.eval_epoch()
    assert va_loss[0] == pytest.approx(sv_loss, rel=1e-5, abs=1e-6)
    assert va_map[0] == pytest.approx(sv_met["mAP"], abs=2e-6)
    member = ens.member_params(params, 0)
    for name, p in trainer.model.named_parameters():
        torch.testing.assert_close(member[name], p.detach(), rtol=1e-5,
                                   atol=1e-6, msg=name)


def test_lr_sweep_member_independence(tmp_path):
    """lr 0 freezes its member bit for bit (the decay factor 1 - lr wd is
    exactly 1); distinct lrs make distinct members from one seed."""
    ens, _, _ = _ensemble(_cfg(tmp_path), np.random.default_rng(2),
                          seeds=[3, 3, 3], learning_rates=[0.0, 1e-3, 1e-2])
    params, opt_state = ens.init_state()
    init0 = ens.member_params(params, 0)
    params, opt_state, *_ = ens.train_epoch(params, opt_state, 0, 0)
    frozen = ens.member_params(params, 0)
    for name, t in init0.items():
        assert torch.equal(frozen[name], t), name
    p1, p2 = ens.member_params(params, 1), ens.member_params(params, 2)
    assert any(not torch.allclose(p1[n], p2[n]) for n in p1)


def test_identical_seeds_are_identical_members(tmp_path):
    ens, _, _ = _ensemble(_cfg(tmp_path), np.random.default_rng(3),
                          seeds=[7, 7])
    params, opt_state = ens.init_state()
    _, _, _, losses, per, ens_map = ens.train_epoch(params, opt_state, 0, 0)
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    assert per[0] == pytest.approx(per[1], abs=1e-6)
    # the mean of identical sigmoid matrices is the member's matrix
    assert ens_map == pytest.approx(per[0], abs=1e-6)


def test_each_epoch_reads_2k_plus_1_scalars(tmp_path, monkeypatch):
    reads = []
    read = device_epoch.read_scalars

    def counted(*values):
        reads.append(len(values))
        return read(*values)

    monkeypatch.setattr(device_epoch, "read_scalars", counted)
    ens, _, _ = _ensemble(_cfg(tmp_path, epochs=2), np.random.default_rng(4),
                          n_models=3)
    ens.run()
    assert reads == [7] * 4


def test_run_report_and_best_checkpoint(tmp_path):
    """``run()``'s report; ``ensemble-best`` loads into a single model by
    ``checkpoint.load_params`` and, with its AdamW state, into a Trainer's
    model and optimizer."""
    cfg = _cfg(tmp_path, epochs=2, save_best_checkpoint=True)
    ens, _, _ = _ensemble(cfg, np.random.default_rng(5), n_models=2)
    report = ens.run()
    assert report["n_models"] == 2
    assert 0.0 <= report["best_member_val_mAP"] <= 1.0
    assert 0.0 <= report["ensemble_val_mAP"] <= 1.0
    assert len(report["history"]) == 2
    model = get_model(cfg, "cpu", torch.Generator().manual_seed(0))
    ckpt.load_params(cfg.checkpoint_dir, "ensemble-best", model)
    meta = ckpt.load_meta(cfg.checkpoint_dir, "ensemble-best")
    assert meta["seed"] in ens.seeds
    assert meta["metric"] == pytest.approx(report["best_member_val_mAP"])
    trainer = Trainer(cfg, "cpu")
    has_opt, step, metric, epoch = ckpt.load_checkpoint(
        cfg.checkpoint_dir, "ensemble-best", trainer.model, trainer.optimizer)
    assert has_opt and step == meta["step"] and epoch == meta["epoch"]
    state = trainer.optimizer.state[next(trainer.model.parameters())]
    assert float(state["step"]) == step


def test_kill_resume_bit_equal_trajectory(tmp_path):
    """A K-member run killed after epoch 2 resumes from ``ensemble-resume``
    on the trajectory of an uninterrupted run, bit for bit; a resume with
    other members refuses."""

    def fresh(cfg):
        return _ensemble(cfg, np.random.default_rng(7), n_models=3)[0]

    report_full = fresh(_cfg(tmp_path / "full", epochs=4,
                             save_best_checkpoint=True)).run()
    cfg_a = _cfg(tmp_path / "int", epochs=2, save_best_checkpoint=True)
    fresh(cfg_a).run()
    assert ckpt.load_meta(cfg_a.checkpoint_dir,
                          EnsembleTrainer.RESUME_NAME)["epoch"] == 2
    cfg_b = dataclasses.replace(cfg_a, epochs=4,
                                resume_from=EnsembleTrainer.RESUME_NAME)
    report_res = fresh(cfg_b).run()
    assert len(report_res["history"]) == 4
    for h_full, h_res in zip(report_full["history"], report_res["history"]):
        for key in ("train_loss", "val_loss", "val_mAP", "ensemble_val_mAP"):
            np.testing.assert_array_equal(h_full[key], h_res[key])
    assert report_res["best_member"] == report_full["best_member"]
    with pytest.raises(ValueError, match="seeds"):
        fresh(dataclasses.replace(cfg_b, random_seed=99)).run()


def test_resume_checkpoint_written_without_best_checkpointing(tmp_path):
    cfg = _cfg(tmp_path, epochs=2, save_best_checkpoint=False)
    _ensemble(cfg, np.random.default_rng(7), n_models=2)[0].run()
    meta = ckpt.load_meta(cfg.checkpoint_dir, EnsembleTrainer.RESUME_NAME)
    assert meta["epoch"] == 2
    assert not (Path(cfg.checkpoint_dir) / "ensemble-best").exists()


def test_arg_validation(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="same length"):
        EnsembleTrainer(cfg, "cpu", seeds=[1, 2], learning_rates=[1e-3])
    with pytest.raises(ValueError, match="n_models"):
        EnsembleTrainer(cfg, "cpu", n_models=0)
    with pytest.raises(ValueError, match="single-device"):
        EnsembleTrainer(dataclasses.replace(cfg, model_parallel=2), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        EnsembleTrainer(cfg, "cpu", n_models=2, mesh=object())
    # lstm_backend is accepted as it is: the device picks the kernel
    ens = EnsembleTrainer(_cfg(tmp_path, **LSTM, lstm_backend="pallas"),
                          "cpu", n_models=2)
    assert ens.config.lstm_backend == "pallas"


@pytest.mark.parametrize("family,knob", [
    ("lstm", dict(lstm_remat_chunk=5)),
    ("bert", dict(transformer_remat=True)),
])
def test_ensemble_remat_matches_without(tmp_path, family, knob):
    """Remat inside an ensemble (the recompute seam under the member axis),
    with dropout: the trajectory of the ensemble without it."""
    model = LSTM if family == "lstm" else dict(
        model_type="bert", hidden_size=64, num_layers=1,
        transformer_max_position=T, transformer_attention="xla",
        compute_dtype="float32")
    hist = []
    for on in (False, True):
        cfg = _cfg(tmp_path / str(on), **model, dropout=0.1,
                   learning_rate=3e-3, **(knob if on else {}))
        ens, _, _ = _ensemble(cfg, np.random.default_rng(8), n_models=2)
        hist.append(_epochs(ens, *ens.init_state())[0])
    for g, w in zip(*hist):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_command_line_on_a_token_corpus(tmp_path):
    """``main`` with ``--device cpu``: the corpora packed from the
    pipeline's token artifacts (``load_corpora``), two members, a report."""
    token_corpus.make_token_corpus(tmp_path)
    report = main(["--device", "cpu", "--n_models", "2", "--lrs",
                   "1e-3,3e-3", "--base_dir", str(tmp_path),
                   "--model_type", "simple", "--hidden_size", "16",
                   "--max_seq_len", "64", "--training_batch_size", "4",
                   "--epochs", "1", "--num_workers", "1",
                   "--save_best_checkpoint", "false"])
    assert report["learning_rates"] == [1e-3, 3e-3]
    assert len(report["history"]) == 1


def test_bench_training_flops_equal_jax():
    """``tools/bench_training.py``'s cases and FLOP counts are the JAX
    tool's."""
    from audio_tokens_tpu.tools import bench_training as jax_bench
    from audio_tokens_tpu_torch.tools import bench_training

    assert bench_training.DEFAULT_CASES == jax_bench.DEFAULT_CASES
    for _, model_type, batch, seq, overrides in bench_training.DEFAULT_CASES:
        cfg = bench_training.case_config(model_type, seq, **overrides)
        jcfg = JaxConfig(model_type=model_type, vocab_size=500,
                         num_classes=543, max_seq_len=seq, **overrides)
        assert bench_training._train_flops(model_type, cfg, batch, seq) == (
            jax_bench._train_flops(model_type, jcfg, batch, seq))


def test_bench_training_runs_tiny_on_cpu(capsys):
    """Every bench of the tool at a tiny shape on the CPU (asked for)."""
    from audio_tokens_tpu_torch.tools import bench_training as bt

    small = dict(hidden_size=8, vocab_size=20, num_classes=5)
    assert bt.bench_case("simple", 4, 16, 2, "cpu", **small) > 0
    assert bt.bench_forward_case("simple", 4, 16, 2, "cpu", **small) > 0
    assert bt.bench_real_loop("simple", 4, 16, 1, 2, "cpu", **small) > 0
    assert bt.bench_device_loop("simple", 4, 16, 1, 2, "cpu", **small) > 0
    got = bt.bench_ensemble("simple", 4, 16, 1, 2, 2, "cpu", **small)
    assert got["tk_ms"] > 0 and got["cost_per_member"] > 0
    assert "ensemble epoch x2 members" in capsys.readouterr().out


def test_empty_validation_split_reads_nothing(tmp_path):
    """A validation split without clips: NaN losses and mAP 0, as the single
    device epoch reports it, and no read of the device."""
    ens, _, _ = _ensemble(_cfg(tmp_path), np.random.default_rng(9),
                          n_models=2)
    ens.set_corpus_arrays("validation", np.zeros((0, T), np.uint16),
                          np.zeros(0, np.int32), np.zeros((0, C), np.uint8),
                          n_real=0, batch_size=B)
    params, _ = ens.init_state()
    losses, per, ens_map = ens.eval_epoch(params)
    assert np.isnan(losses).all() and (per == 0).all() and ens_map == 0.0
