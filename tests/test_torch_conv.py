"""The port's conv front-end (``ops/conv_features.ConvFeatures``) against
the JAX package's ``ConvFeatures``, and ``use_convolution=True`` through the
port's staged and fused pipelines against the JAX stages on copies of one
fixture workspace, the JAX conv weights carried across
(``convert.conv_state_dict``).

Tolerances: the conv output within 1e-6 (f32 sums of ``kernel_size``
products in another order); centroids within 1e-5 (the two Lloyd loops sum
in other orders); tokens equal except at near-ties."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu.data.splitter import DatasetSplitter
from audio_tokens_tpu.ops.conv_features import ConvFeatures as JaxConv
from audio_tokens_tpu.processors.cluster_creator import (
    ClusterCreator as JaxClusterCreator,
)
from audio_tokens_tpu.processors.spec_tokenizer import (
    SpecTokenizer as JaxSpecTokenizer,
)
from audio_tokens_tpu.processors.spectrogram_generator import (
    SpectrogramGenerator as JaxSpectrogramGenerator,
)
from audio_tokens_tpu.utils.seeding import key_for
from audio_tokens_tpu_torch import run_pipeline
from audio_tokens_tpu_torch.convert import conv_state_dict
from audio_tokens_tpu_torch.ops.conv_features import ConvFeatures
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.processors import (
    ClusterCreator,
    SpecTokenizer,
    SpectrogramGenerator,
)
from audio_tokens_tpu_torch.processors import cluster_creator
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from tests import fixtures
from tests.test_torch_pipeline import port_config

SPLITS = ("train", "validation")


def _jax_conv(num_kernels=10, kernel_size=3, seed=0):
    return JaxConv(num_kernels, kernel_size, key_for(seed, "conv_features"))


@pytest.mark.parametrize("num_kernels,kernel_size", [(10, 3), (4, 5)])
def test_conv_matches_jax_with_carried_weights(num_kernels, kernel_size):
    jconv = _jax_conv(num_kernels, kernel_size)
    conv = ConvFeatures(num_kernels, kernel_size)
    conv.load_state_dict(conv_state_dict(jconv.state_dict()))
    x = np.random.default_rng(0).standard_normal((300, 64)).astype(
        np.float32)
    ref = np.asarray(jconv(x))
    got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == (300, 64 * num_kernels)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_output_is_mel_major():
    """Feature m * K + k is kernel k's output at mel bin m."""
    conv = ConvFeatures(3, 3)
    x = torch.randn(5, 16)
    out = conv(x).reshape(5, 16, 3)
    xp = torch.nn.functional.pad(x, (1, 1))
    for k in range(3):
        w, b = conv.weight[k, 0], conv.bias[k]
        for m in (0, 7, 15):
            ref = (xp[:, m:m + 3] * w).sum(1) + b
            torch.testing.assert_close(out[:, m, k], ref, atol=1e-6, rtol=0)


def test_seeded_draw_distribution_and_stability():
    a, b = ConvFeatures(10, 3, seed=7), ConvFeatures(10, 3, seed=7)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert not torch.equal(a.weight, ConvFeatures(10, 3, seed=8).weight)
    bound = 1.0 / np.sqrt(3)
    assert a.weight.shape == (10, 1, 3) and a.bias.shape == (10,)
    assert float(a.weight.abs().max()) <= bound
    with pytest.raises(ValueError, match="odd"):
        ConvFeatures(10, 4)


def test_jax_conv_npz_loads_in_the_port(tmp_path):
    """The ``.conv.npz`` the JAX stage saves beside its centroids loads into
    the port's module and computes the JAX function; the port saves the
    same layout back."""
    jconv = _jax_conv()
    path = tmp_path / "centroids.conv.npz"
    np.savez(path, **jconv.state_dict())
    conv = ConvFeatures(10, 3, seed=123)
    conv.load_state_dict(dict(np.load(path)))
    x = np.random.default_rng(1).standard_normal((50, 32)).astype(np.float32)
    np.testing.assert_allclose(conv(torch.from_numpy(x)).numpy(),
                               np.asarray(jconv(x)), atol=1e-6, rtol=0)
    out = tmp_path / "port.conv.npz"
    conv.save_npz(out)
    back = dict(np.load(out))
    assert sorted(back) == ["bias", "weight"]
    np.testing.assert_array_equal(back["weight"],
                                  jconv.state_dict()["weight"])


# ---- the pipeline ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_conv_runs(tmp_path_factory):
    """A split fixture workspace, copied fresh; the JAX staged stages with
    ``use_convolution`` on one copy in ``batch_warm_start`` and, on another
    copy of its spectrograms, the clustering stage in ``full`` mode."""
    root = tmp_path_factory.mktemp("torch_conv")
    fresh = root / "fresh"
    fixtures.make_workspace(fresh)
    jcfg = fixtures.test_config(fresh)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    warm = root / "jax_warm"
    shutil.copytree(fresh, warm)
    jcfg = fixtures.test_config(warm, audio_backend="python",
                                use_convolution=True)
    JaxSpectrogramGenerator(jcfg).run()
    jcc = JaxClusterCreator(jcfg)
    jcc.run()
    JaxSpecTokenizer(jcfg).run()
    full = root / "jax_full"
    shutil.copytree(warm, full)
    jfull = fixtures.test_config(full, audio_backend="python",
                                 use_convolution=True, kmeans_mode="full")
    JaxClusterCreator(jfull).run()
    return dict(fresh=fresh, warm=jcfg, full=jfull,
                state=jcc.conv.state_dict())


@pytest.fixture
def jax_weights(jax_conv_runs, monkeypatch):
    """The clustering stage draws the JAX stage's weights (the tokenize
    stage draws its own and must read the saved ``.conv.npz``)."""
    state = conv_state_dict(jax_conv_runs["state"])
    make = cluster_creator.make_conv_features

    def make_jax(config, device="cpu"):
        conv = make(config, device)
        if conv is not None:
            conv.load_state_dict(state)
        return conv

    monkeypatch.setattr(cluster_creator, "make_conv_features", make_jax)


def _tokens(cfg, split):
    root = Path(cfg.dest_tokenized_path) / split
    return {p.stem: np.load(p) for p in sorted(root.glob("*.npy"))}


def _check_against_jax(cfg, jcfg, conv):
    """Centroids within 1e-5 of the JAX stage's; tokens equal to the JAX
    tokenize stage's except at near-ties (features: the JAX
    spectrograms through the conv, normalized)."""
    cents = np.load(jcfg.centroids_path)
    np.testing.assert_allclose(np.load(cfg.centroids_path), cents,
                               atol=1e-5, rtol=0)
    feats, got, ref = [], [], []
    for split in SPLITS:
        a, b = _tokens(jcfg, split), _tokens(cfg, split)
        assert sorted(a) == sorted(b) and a
        for ytid in a:
            spec = np.load(Path(jcfg.dest_spec_path) / split
                           / f"{ytid}.npy").T
            feats.append(l2_normalize(conv(torch.from_numpy(
                np.ascontiguousarray(spec)))))
            got.append(torch.from_numpy(b[ytid]))
            ref.append(torch.from_numpy(a[ytid]))
    check_near_ties(torch.cat(feats), torch.from_numpy(cents),
                    torch.cat(got), torch.cat(ref))


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_with_conv_matches_jax(jax_conv_runs, jax_weights,
                                        tmp_path, fused):
    """Staged stages and the fused pipeline (batch_warm_start) with
    ``use_convolution``: the JAX stages' centroids and tokens; the tokenize
    stage reuses the clustering stage's saved weights."""
    base = tmp_path / "ws"
    shutil.copytree(jax_conv_runs["fresh"], base)
    cfg = port_config(base, use_convolution=True, audio_backend="python",
                      fused_pipeline=fused)
    if fused:
        run_pipeline.main(cfg, "cpu")
    else:
        SpectrogramGenerator(cfg, "cpu").run()
        ClusterCreator(cfg, "cpu").run()
        tok = SpecTokenizer(cfg, "cpu")
        assert torch.equal(tok.conv.weight, conv_state_dict(
            jax_conv_runs["state"])["weight"])
        tok.run()
    saved = np.load(Path(cfg.centroids_path).with_suffix(".conv.npz"))
    np.testing.assert_array_equal(saved["weight"],
                                  jax_conv_runs["state"]["weight"])
    conv = ConvFeatures(cfg.num_kernels, cfg.kernel_size)
    conv.load_state_dict(dict(saved))
    _check_against_jax(cfg, jax_conv_runs["warm"], conv)


def test_fused_device_feed_with_conv_matches_jax_full_fit(
        jax_conv_runs, jax_weights, tmp_path, caplog):
    """``kmeans_mode="full"`` under the fused mode: the device feed widens
    each batch's frames with the conv before normalizing them, and the fit
    on its buffer gives the JAX stage's full-mode centroids."""
    import logging

    base = tmp_path / "ws"
    shutil.copytree(jax_conv_runs["fresh"], base)
    cfg = port_config(base, use_convolution=True, audio_backend="python",
                      fused_pipeline=True, kmeans_mode="full")
    with caplog.at_level(logging.INFO):
        cc = ClusterCreator(cfg, "cpu")
        got = cc.run()
    assert cc.used_device_feed
    assert got.shape[1] == cfg.n_mels * cfg.num_kernels
    np.testing.assert_allclose(got, np.load(jax_conv_runs["full"]
                                            .centroids_path),
                               atol=1e-5, rtol=0)


def test_streaming_fit_with_conv_matches_jax(jax_conv_runs, jax_weights,
                                             tmp_path):
    """``kmeans_streaming="always"``: the stream and its init sample go
    through the conv on the stage's device before the normalization, and
    the streaming fit gives the JAX streaming stage's centroids on copies
    of one workspace's spectrograms."""
    stream = dict(use_convolution=True, audio_backend="python",
                  kmeans_mode="full", kmeans_streaming="always",
                  kmeans_superbatch_rows=1024)
    warm = Path(jax_conv_runs["warm"].base_dir)
    jbase, pbase = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(warm, jbase)
    shutil.copytree(warm, pbase)
    ref = JaxClusterCreator(fixtures.test_config(
        jbase, data_parallel=1, **stream)).run()
    cfg = port_config(pbase, **stream)
    cc = ClusterCreator(cfg, "cpu")
    assert cc._should_stream()
    got = cc.run()
    assert got.shape == ref.shape == (cfg.vocab_size,
                                      cfg.n_mels * cfg.num_kernels)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_from_artifacts_loads_the_conv(jax_conv_runs, tmp_path):
    """``FusedTokenizer.from_artifacts`` reads ``<centroids>.conv.npz``
    (the JAX stage's weights) and takes the staged route (the conv
    disables B1)."""
    jcfg = jax_conv_runs["warm"]
    cfg = port_config(Path(jcfg.base_dir), use_convolution=True)
    tok = FusedTokenizer.from_artifacts(cfg, "cpu")
    assert tok.kernel is None and tok.conv is not None
    np.testing.assert_array_equal(tok.conv.weight.numpy(),
                                  jax_conv_runs["state"]["weight"])
