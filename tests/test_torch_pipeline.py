"""The port's staged pipeline (spectrograms -> centroids -> tokens ->
training, ``audio_tokens_tpu_torch/processors`` and ``run_pipeline``) against
the JAX package's stages on copies of one synthetic workspace
(``tests/fixtures.make_workspace``: 24 clips, every 6th stereo), on the CPU.

Tolerances: spectrograms atol 5e-3 dB + rtol 1e-4 (the two frontends sum
the DFT in other orders, as in test_torch_mel.py); centroids 1e-5 (the two
Lloyd loops sum in other orders); tokens equal except at near-ties
(``ops/vq.check_near_ties``) against the JAX centroids."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu.data.splitter import DatasetSplitter
from audio_tokens_tpu.processors.cluster_creator import (
    ClusterCreator as JaxClusterCreator,
)
from audio_tokens_tpu.processors.spec_tokenizer import (
    SpecTokenizer as JaxSpecTokenizer,
)
from audio_tokens_tpu.processors.spectrogram_generator import (
    SpectrogramGenerator as JaxSpectrogramGenerator,
)
from audio_tokens_tpu_torch import run_pipeline
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.processors import (
    ClusterCreator,
    SpecTokenizer,
    SpectrogramGenerator,
)
from tests import fixtures

SPLITS = ("train", "validation")


def port_config(base: Path, **overrides) -> AudioTokensConfig:
    """The port's config with the fields of ``fixtures.test_config``."""
    jcfg = fixtures.test_config(base)
    kw = {f: getattr(jcfg, f) for f in (
        "dataset_ratio", "validation_ratio", "num_classes", "vocab_size",
        "niter", "clip_seconds", "device_batch_size", "n_mels", "n_fft",
        "hop_length", "max_seq_len", "epochs", "training_batch_size",
        "hidden_size", "lstm_embed_dim", "lstm_hidden_dim")}
    kw.update(overrides)
    return AudioTokensConfig(base_dir=str(base), **kw)


def _run_port_stages(cfg):
    SpectrogramGenerator(cfg, "cpu").run()
    ClusterCreator(cfg, "cpu").run()
    return SpecTokenizer(cfg, "cpu").run()


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """One split workspace, copied before any stage ran (``fresh``), then
    the JAX stages on one copy and the port's on another.  The JAX side
    decodes in python, the port's only decode."""
    root = tmp_path_factory.mktemp("torch_pipeline")
    fresh = root / "fresh"
    fixtures.make_workspace(fresh)
    jcfg = fixtures.test_config(fresh)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    jax_ws, port_ws = root / "jax", root / "port"
    shutil.copytree(fresh, jax_ws)
    shutil.copytree(fresh, port_ws)
    jcfg = fixtures.test_config(jax_ws, audio_backend="python")
    JaxSpectrogramGenerator(jcfg).run()
    JaxClusterCreator(jcfg).run()
    jax_stats = JaxSpecTokenizer(jcfg).run()
    pcfg = port_config(port_ws)
    port_stats = _run_port_stages(pcfg)
    return dict(fresh=fresh, jcfg=jcfg, pcfg=pcfg, jax_stats=jax_stats,
                port_stats=port_stats)


def _files(cfg, kind, split):
    root = (cfg.dest_spec_path if kind == "spec"
            else Path(cfg.dest_tokenized_path))
    return sorted((Path(root) / split).glob("*.npy"))


def test_spectrograms_match_jax(workspaces):
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    split = json.loads(Path(pcfg.split_file).read_text())
    for s in SPLITS:
        jf, pf = _files(jcfg, "spec", s), _files(pcfg, "spec", s)
        assert [f.name for f in pf] == [f.name for f in jf]
        assert len(pf) == len(split[s])
        for a, b in zip(jf, pf):
            ref, got = np.load(a), np.load(b)
            assert got.dtype == np.float32 and got.shape == ref.shape
            assert got.shape[0] == pcfg.n_mels
            np.testing.assert_allclose(got, ref, atol=5e-3, rtol=1e-4)


def test_spectrogram_signature_matches_jax(workspaces):
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    for s in SPLITS:
        name = "_signature.json"
        assert ((Path(pcfg.dest_spec_path) / s / name).read_text()
                == (Path(jcfg.dest_spec_path) / s / name).read_text())


def test_centroids_match_jax(workspaces):
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    ref, got = np.load(jcfg.centroids_path), np.load(pcfg.centroids_path)
    assert got.dtype == np.float32 and got.shape == (pcfg.vocab_size,
                                                     pcfg.n_mels)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _disagreements(workspaces):
    """Token files of both runs, held under the near-tie rule against the
    JAX centroids; returns the number of differing tokens."""
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    cents = torch.from_numpy(np.load(jcfg.centroids_path))
    n_diff = 0
    for s in SPLITS:
        jf, pf = _files(jcfg, "tok", s), _files(pcfg, "tok", s)
        assert [f.name for f in pf] == [f.name for f in jf]
        specs = _files(pcfg, "spec", s)
        for a, b, spec in zip(jf, pf, specs):
            ref, got = np.load(a), np.load(b)
            assert got.dtype == np.int64 and got.shape == ref.shape
            assert got.shape == (np.load(spec).shape[1],)
            frames = l2_normalize(torch.from_numpy(np.load(spec).T.copy()))
            check_near_ties(frames, cents, torch.from_numpy(got),
                            torch.from_numpy(ref))
            n_diff += int((got != ref).sum())
    return n_diff


def test_tokens_match_jax_up_to_near_ties(workspaces):
    _disagreements(workspaces)


def test_token_count_ledger_matches_jax(workspaces):
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    name = "train.token_counts.npz"
    ref = np.load(Path(jcfg.dest_tokenized_path) / name)
    got = np.load(Path(pcfg.dest_tokenized_path) / name)
    assert set(got.files) == set(ref.files) == {"counts", "ytids",
                                                "cent_mtime"}
    for key in got.files:
        assert got[key].dtype.kind == ref[key].dtype.kind, key
    np.testing.assert_array_equal(got["ytids"], ref["ytids"])
    own = sum(np.bincount(np.load(f), minlength=pcfg.vocab_size)
              for f in _files(pcfg, "tok", "train"))
    np.testing.assert_array_equal(got["counts"], own)
    assert np.abs(got["counts"] - ref["counts"]).sum() <= 2 * \
        _disagreements(workspaces)


def test_token_stats_match_jax(workspaces):
    """The port's statistics are the JAX function of its own counts, and
    the JAX run's statistics where the tokens agree."""
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    got = workspaces["port_stats"]["train"]
    counts = np.load(Path(pcfg.dest_tokenized_path)
                     / "train.token_counts.npz")["counts"]
    assert got == JaxSpecTokenizer(jcfg).analyze_token_counts(counts)
    assert got["total_tokens"] == workspaces["jax_stats"]["train"][
        "total_tokens"]
    if _disagreements(workspaces) == 0:
        assert got == workspaces["jax_stats"]["train"]


def test_rerun_is_destructive_and_bit_deterministic(workspaces):
    pcfg = workspaces["pcfg"]
    tok_dir = Path(pcfg.dest_tokenized_path) / "train"
    before = {f.name: np.load(f) for f in _files(pcfg, "tok", "train")}
    cents = np.load(pcfg.centroids_path)
    stats = workspaces["port_stats"]
    marker = tok_dir / "stale_marker.npy"
    np.save(marker, np.zeros(3))
    ClusterCreator(pcfg, "cpu").run()
    assert SpecTokenizer(pcfg, "cpu").run() == stats
    assert not marker.exists()
    np.testing.assert_array_equal(np.load(pcfg.centroids_path), cents)
    after = {f.name: np.load(f) for f in _files(pcfg, "tok", "train")}
    assert after.keys() == before.keys()
    for name, toks in before.items():
        np.testing.assert_array_equal(after[name], toks)


def test_incremental_rerun_statistics_equal_destructive(workspaces):
    """Delete some token files, rerun incrementally: only those are
    re-tokenized, and the ledger's statistics are whole-corpus."""
    pcfg = workspaces["pcfg"]
    stats = workspaces["port_stats"]
    files = _files(pcfg, "tok", "train")
    kept_mtime = files[-1].stat().st_mtime_ns
    for f in files[:3]:
        f.unlink()
    inc = port_config(Path(pcfg.base_dir), incremental=True)
    assert SpecTokenizer(inc, "cpu").run() == stats
    assert len(_files(pcfg, "tok", "train")) == len(files)
    assert files[-1].stat().st_mtime_ns == kept_mtime
    # an incremental spectrogram rerun renders only what is missing
    spec = _files(pcfg, "spec", "validation")[0]
    ref = np.load(spec)
    spec.unlink()
    SpectrogramGenerator(inc, "cpu").run()
    np.testing.assert_array_equal(np.load(spec), ref)


def test_full_mode_fit_matches_jax(workspaces, tmp_path):
    """``kmeans_mode='full'``: one in-memory fit over every train frame."""
    jcfg, pcfg = workspaces["jcfg"], workspaces["pcfg"]
    jfull = fixtures.test_config(
        Path(jcfg.base_dir), kmeans_mode="full",
        centroids_path=tmp_path / "jax.npy")
    pfull = port_config(Path(pcfg.base_dir), kmeans_mode="full",
                        centroids_path=tmp_path / "port.npy")
    ref = JaxClusterCreator(jfull).run()
    got = ClusterCreator(pfull, "cpu").run()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_evaluate_clustering_equals_jax(workspaces):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((300, 6)).astype(np.float32)
    labels = rng.integers(0, 4, 300)
    got = ClusterCreator(workspaces["pcfg"], "cpu").evaluate_clustering(
        data, labels, sample_size=200)
    ref = JaxClusterCreator(workspaces["jcfg"]).evaluate_clustering(
        data, labels, sample_size=200)
    assert got == ref


@pytest.mark.parametrize("stage,override,match", [
    ("spec", {"audio_backend": "native"}, "ROADMAP A6"),
    ("spec", {"profile_dir": "trace"}, "ROADMAP A7"),
    ("spec", {"distributed": True}, "ROADMAP A7"),
    ("cluster", {"fused_pipeline": True}, "ROADMAP A3"),
    ("cluster", {"use_convolution": True}, "ROADMAP A6"),
    ("cluster", {"kmeans_precision": "default"}, "ROADMAP A6"),
    ("cluster", {"kmeans_wire": "bf16"}, "ROADMAP A2"),
    ("cluster", {"kmeans_stream_cache_mb": 64}, "ROADMAP A2"),
    ("cluster", {"kmeans_stream_spill_mb": 64}, "ROADMAP A2"),
    ("cluster", {"kmeans_mode": "full", "kmeans_streaming": "always"},
     "ROADMAP A2"),
    ("tokenize", {"fused_pipeline": True}, "ROADMAP A3"),
    ("tokenize", {"use_convolution": True}, "ROADMAP A6"),
    ("pipeline", {"fused_pipeline": True}, "ROADMAP A3"),
])
def test_unported_options_refused(workspaces, tmp_path, stage, override,
                                  match):
    base = tmp_path / "ws"
    shutil.copytree(workspaces["fresh"], base)
    cfg = port_config(base, **override)
    with pytest.raises(NotImplementedError, match=match):
        if stage == "spec":
            SpectrogramGenerator(cfg, "cpu").run()
        elif stage == "cluster":
            ClusterCreator(cfg, "cpu").run()
        elif stage == "tokenize":
            SpecTokenizer(cfg, "cpu").run()
        else:
            run_pipeline.main(cfg, "cpu")


def test_run_pipeline_trains_end_to_end(workspaces, tmp_path):
    """``run_pipeline.main(cfg, "cpu")`` on a fresh workspace: every
    artifact, then 2 epochs of the lstm and a finite validation mAP."""
    base = tmp_path / "ws"
    shutil.copytree(workspaces["fresh"], base)
    cfg = port_config(base)
    val_loss, val_metrics = run_pipeline.main(cfg, "cpu")
    assert np.isfinite(val_loss)
    assert 0.0 <= val_metrics["mAP"] <= 1.0
    assert (Path(cfg.checkpoint_dir) / "no-wandb-best" / "params.pt").exists()
    np.testing.assert_array_equal(np.load(cfg.centroids_path),
                                  np.load(workspaces["pcfg"].centroids_path))
    for s in SPLITS:
        assert len(_files(cfg, "tok", s)) == len(_files(cfg, "spec", s)) > 0
