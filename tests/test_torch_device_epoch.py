"""The port's device-resident epochs (``train/device_epoch.py``) on the CPU:
against the port's streaming ``Trainer`` (the same steps on the same
batches) and against the JAX package's ``DeviceEpochRunner`` under a weight
transplant (``convert.state_dict_for``): per-epoch loss within rel 1e-4 /
abs 1e-6, mAP within 1e-4, parameters within rtol 1e-4 / atol 1e-6.  Then
``Trainer.run()``'s choice of route (the default engages, the budget
fallback and its ``device_map_bins`` hint, ``'off'``), ``max_train_steps``,
the spec and flat corpora in float32 and bfloat16, the epoch gather against
the step gather, the binned metric, corpus-scale residency by the binned
metric, ``evaluate`` through the validation-only runner, and the one read
of two scalars an epoch.  Mirrors JAX ``tests/test_device_epoch.py``."""

import dataclasses
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.datasets import DataLoaderCreator as JaxLoaders
from audio_tokens_tpu.train import trainer as jax_trainer
from audio_tokens_tpu_torch.convert import state_dict_for
from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator
from audio_tokens_tpu_torch.train import device_epoch
from audio_tokens_tpu_torch.train.trainer import Trainer
from tests import token_corpus
from tests.test_torch_families import make_spec_corpus

LOSS_TOL = dict(rel=1e-4, abs=1e-6)
MAP_ATOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("device_epoch_corpus")
    make_spec_corpus(base)  # tokens, and a spectrogram per clip
    return base


def _cfg(base, tmp, **kw):
    """The port's config: 2 epochs at batch 4 (both splits end in a partial
    batch), the corpus's tokens; ``tmp`` holds checkpoints and history."""
    defaults = dict(epochs=2, checkpoint_dir=str(tmp / "ckpt"),
                    device_corpus="on")
    defaults.update(kw)
    return token_corpus.port_config(base, **defaults)


def _history(ckpt_dir):
    lines = (Path(ckpt_dir) / "no-wandb-metrics.jsonl").read_text()
    return [json.loads(x) for x in lines.splitlines()]


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _same_trajectory(got, want, param_tol=PARAM_TOL):
    """Two (history, state) pairs within the stated tolerances."""
    (h1, s1), (h0, s0) = got, want
    assert len(h1) == len(h0)
    for a, b in zip(h1, h0):
        for key in ("train_loss", "val_loss"):
            assert a[key] == pytest.approx(b[key], **LOSS_TOL), key
        for key in ("train_mAP", "val_mAP"):
            assert a[key] == pytest.approx(b[key], abs=MAP_ATOL), key
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], **param_tol, msg=k)


def _run(cfg):
    t = Trainer(cfg, "cpu")
    result = t.run()
    return t, result, (_history(cfg.checkpoint_dir), _state(t))


@pytest.mark.parametrize("model_type,extra", [
    ("lstm", {"dropout": 0.3}),
    ("simple", {}),
    ("bert", {"transformer_attention": "xla", "dropout": 0.1,
              "num_layers": 1}),
])
def test_device_epoch_matches_streaming(corpus, tmp_path, model_type, extra):
    """The device epoch runs the streaming path's steps (dropout drawn per
    step as there) on the same batches: the same trajectory."""
    runs = {}
    for mode in ("off", "on"):
        cfg = _cfg(corpus, tmp_path / mode, model_type=model_type,
                   device_corpus=mode, **extra)
        runs[mode] = _run(cfg)[2]
    _same_trajectory(runs["on"], runs["off"])


@pytest.mark.parametrize("model_type", ["lstm", "simple"])
def test_device_epoch_matches_jax_device_epoch(corpus, tmp_path, model_type):
    """The port's device epoch against the JAX ``DeviceEpochRunner`` (JAX
    ``Trainer.run`` with ``device_corpus="on"``), the JAX initial weights
    carried over: both runs' per-epoch history and final weights."""
    kw = dict(model_type=model_type, epochs=2, device_corpus="on")
    jcfg = token_corpus.config(corpus, checkpoint_dir=str(tmp_path / "jax"),
                               **kw)
    jt = jax_trainer.Trainer(jcfg)
    train_loader, _ = JaxLoaders(jcfg).get_dataloaders()
    params, _ = jt._init_state(train_loader)  # what run() initializes
    jt.run()
    pt = Trainer(_cfg(corpus, tmp_path / "port", **kw), "cpu")
    pt.model.load_state_dict(state_dict_for(model_type,
                                            jax.device_get(params)))
    pt.run()
    want = (_history(jcfg.checkpoint_dir),
            state_dict_for(model_type, jax.device_get(jt._final_params)))
    _same_trajectory((_history(pt.config.checkpoint_dir), _state(pt)), want)


def test_run_engages_device_corpus_by_default(corpus, tmp_path, caplog):
    cfg = _cfg(corpus, tmp_path, epochs=1, device_corpus="auto")
    with caplog.at_level(logging.INFO,
                         logger="audio_tokens_tpu_torch.train.device_epoch"):
        val_loss, _ = Trainer(cfg, "cpu").run()
    assert any("device corpus train" in r.message for r in caplog.records)
    assert np.isfinite(val_loss)


def test_budget_falls_back_to_streaming(corpus, tmp_path, caplog):
    cfg = _cfg(corpus, tmp_path, device_corpus="auto",
               device_corpus_budget_mb=0)
    trainer = Trainer(cfg, "cpu")
    with caplog.at_level(logging.INFO,
                         logger="audio_tokens_tpu_torch.train.trainer"):
        assert trainer._maybe_device_runner(
            *DataLoaderCreator(cfg).get_dataloaders()) is None
    assert any("streaming batches instead" in r.message
               for r in caplog.records)
    forced = Trainer(dataclasses.replace(cfg, device_corpus="on"), "cpu")
    assert forced._maybe_device_runner(
        *DataLoaderCreator(cfg).get_dataloaders()) is not None


def test_device_corpus_off_respected(corpus, tmp_path):
    cfg = _cfg(corpus, tmp_path, device_corpus="off")
    assert Trainer(cfg, "cpu")._maybe_device_runner(
        *DataLoaderCreator(cfg).get_dataloaders()) is None


def test_max_train_steps_truncates_epoch(corpus, tmp_path):
    cfg = _cfg(corpus, tmp_path)
    trainer = Trainer(cfg, "cpu")
    runner = trainer._maybe_device_runner(
        *DataLoaderCreator(cfg).get_dataloaders())
    full = runner.corpora["train"].n_steps
    assert full == 5
    step, loss, _ = runner.train_epoch(0, 0, max_steps=full - 1)
    assert step == full - 1 and np.isfinite(loss)
    step2, loss2, _ = runner.train_epoch(1, step, max_steps=full - 1)
    assert step2 == step and np.isnan(loss2)  # exhausted: a no-op


def test_each_epoch_reads_two_scalars(corpus, tmp_path, monkeypatch):
    """The loss and the mAP, read together once a train and once an eval
    epoch: nothing else of an epoch comes back to the host."""
    reads = []
    read = device_epoch.read_scalars

    def counted(*values):
        reads.append(len(values))
        return read(*values)

    monkeypatch.setattr(device_epoch, "read_scalars", counted)
    Trainer(_cfg(corpus, tmp_path, epochs=3), "cpu").run()
    assert reads == [2] * 6


@pytest.mark.parametrize("model_type,dataset_type", [
    ("cnn", "RawSTFTDataset"), ("baseline", "RawSTFTFlatDataset")])
def test_device_epoch_spec_families(corpus, tmp_path, model_type,
                                    dataset_type):
    """The float32 spec and flat corpora (the epoch gather, as 'auto' picks
    for them) against streaming, f32 compute."""
    runs = {}
    for mode in ("off", "on"):
        cfg = _cfg(corpus, tmp_path / mode, model_type=model_type,
                   dataset_type=dataset_type, compute_dtype="float32",
                   device_corpus=mode)
        runs[mode] = _run(cfg)[2]
    _same_trajectory(runs["on"], runs["off"])


def test_device_corpus_bf16_spec(corpus, tmp_path):
    """``device_corpus_dtype="bfloat16"`` keeps the spec rows in bf16 (the
    JAX packer's rounding: ``ml_dtypes`` round-to-nearest-even), cast to f32
    in the loss; the trajectory stays near the f32 one."""
    import ml_dtypes

    from audio_tokens_tpu.train.device_epoch import corpus_arrays as jax_pack

    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(corpus, tmp_path / dtype, model_type="baseline",
                   dataset_type="RawSTFTFlatDataset",
                   device_corpus_dtype=dtype)
        trainer = Trainer(cfg, "cpu")
        results[dtype] = trainer.run()
    loaders = DataLoaderCreator(cfg).get_dataloaders()
    runner = trainer._maybe_device_runner(*loaders)
    resident = runner.corpora["train"].inputs
    assert resident.dtype == torch.bfloat16
    jcfg = token_corpus.config(corpus, model_type="baseline",
                               dataset_type="RawSTFTFlatDataset",
                               device_corpus_dtype="bfloat16")
    want, *_ = jax_pack(JaxLoaders(jcfg).get_dataloaders()[0].ds, 4,
                        cfg.max_seq_len)
    assert want.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(resident.view(torch.int16).numpy(),
                                  want.view(np.int16))
    (f_loss, _), (b_loss, b_m) = results["float32"], results["bfloat16"]
    assert b_loss == pytest.approx(f_loss, rel=2e-2, abs=2e-2)
    assert 0.0 <= b_m["mAP"] <= 1.0


def test_device_corpus_dtype_rejects_unknown(corpus, tmp_path):
    with pytest.raises(ValueError, match="device_corpus_dtype"):
        device_epoch._feature_dtype(
            _cfg(corpus, tmp_path, device_corpus_dtype="fp8"))


@pytest.mark.parametrize("model_type,dataset_type", [
    ("simple", "TokenizedSpecDataset"), ("baseline", "RawSTFTFlatDataset")])
def test_epoch_gather_matches_step_gather(corpus, tmp_path, model_type,
                                          dataset_type):
    """``device_epoch_gather='epoch'`` (one permuted copy, then contiguous
    slices) feeds every step the values the per-step gather does: the same
    trajectory bit for bit on the CPU."""
    runs = {}
    for gmode in ("step", "epoch"):
        cfg = _cfg(corpus, tmp_path / gmode, model_type=model_type,
                   dataset_type=dataset_type, compute_dtype="float32",
                   device_epoch_gather=gmode)
        trainer = Trainer(cfg, "cpu")
        runner = trainer._maybe_device_runner(
            *DataLoaderCreator(cfg).get_dataloaders())
        assert runner.materialize_train is (gmode == "epoch")
        runs[gmode] = _run(cfg)[2]
    _same_trajectory(runs["epoch"], runs["step"], dict(rtol=0, atol=0))


def test_trainer_auto_materializes_for_spec(corpus, tmp_path):
    """'auto' takes the epoch gather for spec/flat corpora within budget and
    the step gather for token corpora; 'step' and 'epoch' force it."""
    for model_type, dataset_type, gmode, want in (
            ("baseline", "RawSTFTFlatDataset", "auto", True),
            ("simple", "TokenizedSpecDataset", "auto", False),
            ("baseline", "RawSTFTFlatDataset", "step", False),
            ("simple", "TokenizedSpecDataset", "epoch", True)):
        cfg = _cfg(corpus, tmp_path, model_type=model_type,
                   dataset_type=dataset_type, device_epoch_gather=gmode)
        runner = Trainer(cfg, "cpu")._maybe_device_runner(
            *DataLoaderCreator(cfg).get_dataloaders())
        assert runner.materialize_train is want


def test_binned_epoch_trajectory_identical_metric_close(corpus, tmp_path):
    """``device_map_bins`` changes only the metric: the same losses and
    weights bit for bit, the binned mAP within the binning error of the
    exact one on 18 / 6 rows (one bucket collision moves a class's AP by
    ~1/n_pos; the metric's semantics are held to StreamingMAP in
    ``tests/test_torch_device_metrics.py``)."""
    runs = {}
    for bins in (0, 4096):
        cfg = _cfg(corpus, tmp_path / str(bins), model_type="simple",
                   device_map_bins=bins)
        runs[bins] = _run(cfg)[2]
    (h0, s0), (h1, s1) = runs[0], runs[4096]
    for a, b in zip(h1, h0):
        assert a["train_loss"] == b["train_loss"]
        assert a["val_loss"] == b["val_loss"]
        assert a["train_mAP"] == pytest.approx(b["train_mAP"], abs=6e-2)
        assert a["val_mAP"] == pytest.approx(b["val_mAP"], abs=6e-2)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k


def test_budget_forced_corpus_scale_residency(tmp_path, caplog):
    """A corpus whose exact-metric buffers blow the budget (many rows x 543
    classes) trains device-resident with ``device_map_bins`` set; with bins
    unset the trainer logs the ``device_map_bins`` hint and streams (the
    same estimates as the JAX Trainer's)."""
    from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu.data.splitter import DatasetSplitter
    from audio_tokens_tpu.train.device_epoch import (
        corpus_nbytes as jax_nbytes)
    from tests import fixtures

    n_clips, n_classes, bins = 600, 543, 128
    (tmp_path / "metadata").mkdir()
    fixtures.make_ontology(tmp_path / "metadata" / "ontology.json")
    fixtures.make_segments_csv(
        tmp_path / "metadata" / "balanced_train_segments.csv",
        n_clips=n_clips)
    (tmp_path / "output").mkdir()
    base_kw = dict(epochs=1, num_classes=n_classes, max_seq_len=48,
                   training_batch_size=8, device_corpus="auto",
                   model_type="simple")
    jcfg = token_corpus.config(tmp_path, **base_kw)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    split = json.loads(Path(jcfg.split_file).read_text())
    rng = np.random.default_rng(5)
    for sp, ids in split.items():
        d = Path(jcfg.dest_tokenized_path) / sp
        d.mkdir(parents=True)
        for y in ids:
            np.save(d / f"{y}.npy", rng.integers(
                0, jcfg.vocab_size, int(rng.integers(30, 48))).astype(
                    np.int64))
    loaders = DataLoaderCreator(token_corpus.port_config(
        tmp_path, **base_kw)).get_dataloaders()
    pairs = list(zip(loaders, (8, 8)))

    def est(mb):
        got = sum(device_epoch.corpus_nbytes(
            len(ld.ds), bs, 48, jcfg.n_mels, "tokens", n_classes,
            jcfg.vocab_size, map_bins=mb) for ld, bs in pairs)
        assert got == sum(jax_nbytes(
            len(ld.ds), bs, 48, jcfg.n_mels, "tokens", n_classes,
            jcfg.vocab_size, map_bins=mb) for ld, bs in pairs)
        return got

    budget_mb = max(1, int(np.ceil(est(bins) / 2**20)))
    assert est(bins) <= budget_mb * 2**20 < est(0)
    exact = Trainer(token_corpus.port_config(
        tmp_path, device_map_bins=0, device_corpus_budget_mb=budget_mb,
        **base_kw), "cpu")
    with caplog.at_level(logging.INFO):
        assert exact._maybe_device_runner(*loaders) is None
    assert any("set device_map_bins" in r.message for r in caplog.records)
    binned = Trainer(token_corpus.port_config(
        tmp_path, device_map_bins=bins, device_corpus_budget_mb=budget_mb,
        checkpoint_dir=str(tmp_path / "ckpt"), **base_kw), "cpu")
    assert binned._maybe_device_runner(*loaders) is not None
    val_loss, metrics = binned.run()
    assert np.isfinite(val_loss) and 0.0 <= metrics["mAP"] <= 1.0


def test_evaluate_runs_the_validation_only_runner(corpus, tmp_path, caplog):
    """``evaluate`` makes only the validation corpus resident and reports
    the streaming evaluation's numbers."""
    cfg = _cfg(corpus, tmp_path, epochs=1, save_best_checkpoint=True)
    Trainer(cfg, "cpu").run()
    with caplog.at_level(logging.INFO,
                         logger="audio_tokens_tpu_torch.train.device_epoch"):
        loss, m = Trainer(cfg, "cpu").evaluate("no-wandb-best")
    resident = [r.message for r in caplog.records
                if "device corpus" in r.message]
    assert len(resident) == 1 and "validation" in resident[0]
    s_loss, s_m = Trainer(dataclasses.replace(cfg, device_corpus="off"),
                          "cpu").evaluate("no-wandb-best")
    assert loss == pytest.approx(s_loss, **LOSS_TOL)
    assert m["mAP"] == pytest.approx(s_m["mAP"], abs=MAP_ATOL)
