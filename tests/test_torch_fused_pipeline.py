"""The port's fused pipeline mode (``fused_pipeline=True``: no spectrogram
files; clustering frames from the audio, the device feed and its resident
frames, wav -> tokens through ``FusedTokenizer``) against the port's staged
pipeline and the JAX package's fused pipeline on copies of one synthetic
workspace (``tests/fixtures.make_workspace``: 24 clips, every 6th stereo),
on the CPU.

Tolerances: the fused and staged centroids of the port bit-equal (both
modes hand the fit the same rows: the mel product is row-independent at a
fixed batch shape); against the JAX fused pipeline 1e-5 (the two Lloyd
loops sum in other orders); tokens equal except at near-ties
(``ops/vq.check_near_ties``): the fused tokens come from B1's plain
version (its Nyquist-pruned DFT basis sums in another order than
``MelFrontend``) or from the resident unit rows."""

import json
import shutil
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu.data.splitter import DatasetSplitter
from audio_tokens_tpu.ops import kmeans as jax_km
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
from audio_tokens_tpu_torch.ops import kmeans as km
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.processors import (
    ClusterCreator,
    SpecTokenizer,
    SpectrogramGenerator,
)
from audio_tokens_tpu_torch.processors import cluster_creator as cc_mod
from tests import fixtures
from tests.test_review_fixes import _extensible_float_wav
from tests.test_torch_pipeline import port_config

SPLITS = ("train", "validation")
MODES = ("batch_warm_start", "full")


def _copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


def _fused_run(cfg):
    """The fused mode's clustering and tokenize stages, as
    ``run_pipeline`` joins them; returns the clustering stage."""
    cluster = ClusterCreator(cfg, "cpu")
    cluster.run()
    SpecTokenizer(cfg, "cpu",
                  resident_frames=cluster.take_resident_frames()).run()
    return cluster


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One split workspace (``fresh``); on copies of it, per K-means mode,
    the port's staged stages (spectrograms rendered once), the port's
    fused stages and the JAX package's fused stages (python decode)."""
    root = tmp_path_factory.mktemp("torch_fused")
    fresh = root / "fresh"
    fixtures.make_workspace(fresh)
    jcfg = fixtures.test_config(fresh)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    staged = _copy(fresh, root / "staged")
    SpectrogramGenerator(port_config(staged), "cpu").run()
    out = {"fresh": fresh}
    for mode in MODES:
        cfg = port_config(_copy(staged, root / f"staged_{mode}"),
                          kmeans_mode=mode, kmeans_streaming="never")
        ClusterCreator(cfg, "cpu").run()
        SpecTokenizer(cfg, "cpu").run()
        out["staged", mode] = cfg
        cfg = port_config(_copy(fresh, root / f"fused_{mode}"),
                          kmeans_mode=mode, fused_pipeline=True)
        out["feed", mode] = _fused_run(cfg).used_device_feed
        out["fused", mode] = cfg
        jc = fixtures.test_config(_copy(fresh, root / f"jax_{mode}"),
                                  kmeans_mode=mode, fused_pipeline=True,
                                  audio_backend="python")
        cluster = JaxClusterCreator(jc)
        cluster.run()
        JaxSpecTokenizer(jc, resident_frames=cluster.take_resident_frames()
                         ).run()
        out["jax", mode] = jc
    return out


def _tokens(cfg, split):
    root = Path(cfg.dest_tokenized_path) / split
    return {f.stem: np.load(f) for f in sorted(root.glob("*.npy"))}


def _unit_frames(staged_cfg, split, ytid):
    spec = np.load(Path(staged_cfg.dest_spec_path) / split / f"{ytid}.npy")
    return l2_normalize(torch.from_numpy(spec.T.copy()))


# -- the decode-only wave batches ---------------------------------------------

@pytest.mark.parametrize("n_clips", [4, None])
def test_iter_wave_batches_match_jax(runs, tmp_path, monkeypatch, n_clips):
    """The port's wave batches equal the JAX stage's (python decode):
    waveforms, lengths (-1 on padding rows) and row ytids, with one clip
    scaled past the amplitude screen dropped by both."""
    base = _copy(runs["fresh"], tmp_path / "ws")
    jgen = JaxSpectrogramGenerator(fixtures.test_config(
        base, fused_pipeline=True, audio_backend="python"))
    gen = SpectrogramGenerator(port_config(base, fused_pipeline=True,
                                           audio_backend="python"), "cpu")
    ytids = sorted(gen.data_split["train"])[:n_clips]
    bad = ytids[1]
    for cls in (JaxSpectrogramGenerator, SpectrogramGenerator):
        def rigged(self, ytid, _orig=cls._decode_one):
            wave = _orig(self, ytid)
            return wave * np.float32(1e17) if ytid == bad else wave

        monkeypatch.setattr(cls, "_decode_one", rigged)
    got = list(gen.iter_wave_batches(ytids))
    ref = list(jgen.iter_wave_batches(ytids))
    assert len(got) == len(ref) == -(-(len(ytids) - 1)
                                     // gen.config.device_batch_size)
    for (b, ln, rows), (jb, jln, jrows) in zip(got, ref):
        assert b.dtype == np.float32 and ln.dtype == np.int32
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(ln, jln)
        assert rows == jrows
        assert [y is None for y in rows] == list(ln < 0)
    seen = [y for _, _, rows in got for y in rows if y is not None]
    assert seen == [y for y in ytids if y != bad]


# -- the device feed -------------------------------------------------------------

def test_device_feed_rows_equal_host_generator(runs, tmp_path):
    """The device feed's rows are the host-mediated route's
    (``_batch_generator``: ``iter_specs`` -> frames -> L2) bit for bit, in
    clip and frame order; the manifest names each clip's rows."""
    cfg = port_config(_copy(runs["fresh"], tmp_path / "ws"),
                      fused_pipeline=True, kmeans_mode="full")
    cc = ClusterCreator(cfg, "cpu")
    buffer, n = cc._fused_frames_device()
    host = torch.cat(list(cc._batch_generator(cfg.clustering_batch_size)))
    assert buffer.shape == (cc._feed_capacity_rows(cc._n_train_clips()),
                            cfg.feature_dim)
    assert buffer.shape[0] % km.DEFAULT_CHUNK == 0
    assert torch.equal(buffer[:n], host)
    frames, manifest = cc.take_resident_frames()
    assert frames.data_ptr() == buffer.data_ptr() and frames.shape[0] == n
    assert cc.take_resident_frames() is None
    train = sorted(json.loads(Path(cfg.split_file).read_text())["train"])
    assert list(manifest) == train
    row = 0
    for y in train:
        off, nv = manifest[y]
        assert off == row
        spec = np.load(Path(runs["staged", "full"].dest_spec_path) / "train"
                       / f"{y}.npy")
        assert nv == spec.shape[1]
        row += nv
    assert row == n


def test_device_feed_engages_and_fits_a_view(runs, tmp_path, monkeypatch):
    """``kmeans_mode='full'`` under the fused mode takes the device feed,
    and the fit reads the buffer's rows in place (no copy)."""
    cfg = port_config(_copy(runs["fresh"], tmp_path / "ws"),
                      fused_pipeline=True, kmeans_mode="full")
    seen = []
    real_fit = cc_mod.kmeans_fit

    def spy_fit(x, *args, **kw):
        seen.append((x.data_ptr(), x.shape[0], kw.get("n_valid")))
        return real_fit(x, *args, **kw)

    monkeypatch.setattr(cc_mod, "kmeans_fit", spy_fit)
    cc = ClusterCreator(cfg, "cpu")
    cc.run()
    assert cc.used_device_feed and runs["feed", "full"]
    assert not runs["feed", "batch_warm_start"]
    frames, _ = cc.take_resident_frames()
    (ptr, rows, n_valid), = seen
    assert ptr == frames.data_ptr() and n_valid == frames.shape[0] < rows


@pytest.mark.parametrize("over,engages", [
    ({}, True),
    ({"kmeans_inmemory_budget_mb": 0}, True),
    ({"kmeans_hbm_cache_mb": 1}, False),
    ({"kmeans_hbm_cache_mb": 0}, False),
    ({"normalize": True}, False),
    ({"kmeans_streaming": "always"}, False),
    ({"fused_pipeline": False}, False),
])
def test_device_feed_routing_matches_jax(runs, over, engages):
    """The routing decides as the JAX stage's on one device
    (``data_parallel=1``) at the budgets of the JAX routing tests, with
    the same capacity estimate."""
    base = runs["fresh"]
    kw = {"fused_pipeline": True, "kmeans_mode": "full", **over}
    port = ClusterCreator(port_config(base, **kw), "cpu")
    ref = JaxClusterCreator(fixtures.test_config(base, data_parallel=1, **kw))
    assert port._use_fused_device_feed() == ref._use_fused_device_feed() \
        == engages
    n = port._n_train_clips()
    assert n == ref._n_train_clips()
    assert port._feed_capacity_rows(n) == ref._feed_capacity_rows(n)


# -- kmeans_fit's n_valid ----------------------------------------------------------

@pytest.mark.parametrize("mppc", [None, 40])
def test_kmeans_fit_n_valid_is_the_prefix(mppc):
    """``kmeans_fit(buf, n_valid=n)`` equals ``kmeans_fit(buf[:n])`` bit
    for bit and the JAX fit with ``n_valid=n`` within 1e-5, the rows past
    ``n`` (junk) never read; with a subsample both draw the same rows."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((8, 16)) * 2.0
    n = 3000
    buf = np.full((4096, 16), 1e6, np.float32)
    buf[:n] = centers[rng.integers(0, 8, n)] + rng.standard_normal((n, 16))
    kw = dict(max_points_per_centroid=mppc, seed=5)
    got, obj = km.kmeans_fit(torch.from_numpy(buf), 8, 10, n_valid=n, **kw)
    ref, ref_obj = km.kmeans_fit(torch.from_numpy(buf[:n].copy()), 8, 10,
                                 **kw)
    assert torch.equal(got, ref) and obj == ref_obj
    jc, jobj = jax_km.kmeans_fit(buf, 8, 10, n_valid=n, **kw)
    np.testing.assert_allclose(got.numpy(), jc, atol=1e-5, rtol=0)
    assert abs(obj - jobj) <= 1e-5 * abs(jobj)


def test_kmeans_fit_n_valid_out_of_range_raises():
    x = torch.zeros((10, 4))
    for n in (0, 11):
        with pytest.raises(ValueError, match="n_valid"):
            km.kmeans_fit(x, 2, 1, n_valid=n)


# -- the pipelines ---------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_fused_centroids_equal_staged_and_match_jax(runs, mode):
    fused, staged, jax = (runs[k, mode] for k in ("fused", "staged", "jax"))
    got = np.load(fused.centroids_path)
    np.testing.assert_array_equal(got, np.load(staged.centroids_path))
    np.testing.assert_allclose(got, np.load(jax.centroids_path), atol=1e-5,
                               rtol=0)
    assert not (Path(fused.dest_spec_path) / "train").exists()


@pytest.mark.parametrize("against", ["staged", "jax"])
@pytest.mark.parametrize("mode", MODES)
def test_fused_tokens_match_up_to_near_ties(runs, mode, against):
    """The fused tokens against the port's staged tokens (the same
    centroids) and the JAX fused pipeline's (held on the JAX centroids),
    over every clip of both splits; the artifact sets are identical."""
    fused, other = runs["fused", mode], runs[against, mode]
    cents = torch.from_numpy(np.load(other.centroids_path))
    for split in SPLITS:
        got, ref = _tokens(fused, split), _tokens(other, split)
        assert list(got) == list(ref) and got
        for y, toks in got.items():
            assert toks.dtype == np.int64 and toks.shape == ref[y].shape
            check_near_ties(_unit_frames(runs["staged", mode], split, y),
                            cents, torch.from_numpy(toks),
                            torch.from_numpy(ref[y]))


def test_assign_resident_sparse_route_equals_dense(rng):
    """Few covered clips gather only their rows; both routes give the same
    tokens, which match the JAX stage's up to near-ties."""
    from types import SimpleNamespace

    d, k = 16, 12
    cents = l2_normalize(torch.from_numpy(
        rng.standard_normal((k, d)).astype(np.float32)))
    frames = l2_normalize(torch.from_numpy(
        rng.standard_normal((400, d)).astype(np.float32)))
    manifest = {f"y{i}": (i * 40, 40) for i in range(10)}
    stub = SimpleNamespace(centroids=cents)
    full = SpecTokenizer._assign_resident(stub, frames, manifest,
                                          [f"y{i}" for i in range(10)])
    sparse = SpecTokenizer._assign_resident(stub, frames, manifest,
                                            ["y3", "y7"])
    assert set(sparse) == {"y3", "y7"} and len(full) == 10
    for y in sparse:
        np.testing.assert_array_equal(sparse[y], full[y])
    ref = JaxSpecTokenizer._assign_resident(
        SimpleNamespace(centroids=cents.numpy(), mesh=None), frames.numpy(),
        manifest, list(manifest))
    for y, (off, n) in manifest.items():
        check_near_ties(frames[off:off + n], cents,
                        torch.from_numpy(full[y]), torch.from_numpy(ref[y]))


def test_resident_handoff_released_after_the_train_split(runs, tmp_path):
    """The tokenize stage assigns the train split from the view it is
    handed and keeps no reference to the buffer after the stage."""
    cfg = port_config(_copy(runs["fresh"], tmp_path / "ws"),
                      fused_pipeline=True, kmeans_mode="full")
    cluster = ClusterCreator(cfg, "cpu")
    cluster.run()
    frames, manifest = cluster.take_resident_frames()
    alive = weakref.ref(frames)
    tok = SpecTokenizer(cfg, "cpu", resident_frames=(frames, manifest))
    del frames
    tok.run()
    assert tok.resident is None and alive() is None
    for split in SPLITS:
        got, ref = _tokens(cfg, split), _tokens(runs["fused", "full"], split)
        assert list(got) == list(ref)
        for y in got:
            np.testing.assert_array_equal(got[y], ref[y])


def test_fused_incremental_stats_match_destructive(runs, tmp_path):
    """The fused mode's incremental reruns keep the token-count ledger
    whole-corpus, also after a token file was deleted."""
    base = _copy(runs["fresh"], tmp_path / "ws")
    cfg0 = port_config(base, fused_pipeline=True)
    cents = np.random.default_rng(2).standard_normal(
        (cfg0.vocab_size, cfg0.n_mels)).astype(np.float32)
    np.save(cfg0.centroids_path, cents)
    ledger = Path(cfg0.dest_tokenized_path) / "train.token_counts.npz"

    def run(incremental):
        cfg = port_config(base, fused_pipeline=True, incremental=incremental)
        return SpecTokenizer(cfg, "cpu").run()["train"]

    def summary(stats):  # zipf_slope is nan with this few tokens in use
        return [stats[k] for k in ("total_tokens", "unique_tokens",
                                   "most_common", "least_common")]

    stats0 = run(False)
    counts0 = np.load(ledger)["counts"]
    assert stats0["total_tokens"] == counts0.sum() > 0
    assert summary(run(True)) == summary(stats0)
    victims = sorted((Path(cfg0.dest_tokenized_path) / "train").glob("*.npy"))
    victims[1].unlink()
    assert summary(run(True)) == summary(stats0)
    assert victims[1].exists()
    np.testing.assert_array_equal(np.load(ledger)["counts"], counts0)


def test_fused_pipeline_skips_nonfinite_clips_like_staged(runs, tmp_path):
    """A clip with a NaN sample is dropped by both modes: the same token
    artifact sets."""
    victim = sorted(json.loads(
        (runs["fresh"] / "output" / "bal_train_data_split.json").read_text()
    )["train"])[3]
    results = {}
    for fused in (False, True):
        base = _copy(runs["fresh"], tmp_path / f"ws{fused}")
        bad = np.zeros(30000, np.float32)
        bad[1000] = np.nan
        _extensible_float_wav(
            base / "audioset" / "bal_train" / victim[:2] / f"{victim}.wav",
            bad)
        cfg = port_config(base, fused_pipeline=fused)
        if not fused:
            SpectrogramGenerator(cfg, "cpu").run()
        _fused_run(cfg)
        results[fused] = {(s, y) for s in SPLITS for y in _tokens(cfg, s)}
    assert ("train", victim) not in results[False]
    assert results[True] == results[False]


@pytest.mark.parametrize("over", [{"dataset_type": "RawSTFTDataset"},
                                  {"use_precomputed_embeddings": True}])
def test_fused_pipeline_rejects_spec_consuming_models(runs, tmp_path, over):
    cfg = port_config(_copy(runs["fresh"], tmp_path / "ws"),
                      fused_pipeline=True, **over)
    with pytest.raises(ValueError, match="fused_pipeline"):
        run_pipeline.main(cfg, "cpu")


def test_run_pipeline_fused_trains_end_to_end(runs, tmp_path):
    """``run_pipeline.main`` with ``fused_pipeline=True`` on the CPU: no
    spectrogram directory, the staged run's centroids, the fused stages'
    tokens, 2 epochs of the lstm and a finite validation mAP."""
    cfg = port_config(_copy(runs["fresh"], tmp_path / "ws"),
                      fused_pipeline=True)
    val_loss, val_metrics = run_pipeline.main(cfg, "cpu")
    assert np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0
    assert (Path(cfg.checkpoint_dir) / "no-wandb-best" / "params.pt").exists()
    assert not Path(cfg.dest_spec_path).exists()
    np.testing.assert_array_equal(
        np.load(cfg.centroids_path),
        np.load(runs["staged", "batch_warm_start"].centroids_path))
    for split in SPLITS:
        got = _tokens(cfg, split)
        ref = _tokens(runs["fused", "batch_warm_start"], split)
        assert list(got) == list(ref)
        for y in got:
            np.testing.assert_array_equal(got[y], ref[y])
