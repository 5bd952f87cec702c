"""The port's staged pipeline (spectrograms -> centroids -> tokens ->
training, ``audio_tokens_tpu_torch/processors`` and ``run_pipeline``) against
the JAX package's stages on copies of one synthetic workspace
(``tests/fixtures.make_workspace``: 24 clips, every 6th stereo), on the CPU.

Tolerances: spectrograms atol 5e-3 dB + rtol 1e-4 (the two frontends sum
the DFT in other orders, as in test_torch_mel.py); centroids 1e-5 (the two
Lloyd loops sum in other orders); tokens equal except at near-ties
(``ops/vq.check_near_ties``) against the JAX centroids.

The wire meters (``utils/profiling.WIRE`` of each package) are read around
every stage the fixture runs, staged and fused (both K-means modes, native
decode on both sides): each stage's host-to-card and card-to-host bytes
equal the JAX stage's exactly, but for the one difference by design
(ROADMAP C10: the device feed's frame index)."""

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
from audio_tokens_tpu.utils.profiling import WIRE as JAX_WIRE
from audio_tokens_tpu_torch import run_pipeline
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.processors import (
    ClusterCreator,
    SpecTokenizer,
    SpectrogramGenerator,
)
from audio_tokens_tpu_torch.utils.profiling import WIRE
from tests import fixtures

SPLITS = ("train", "validation")
KMEANS_MODES = ("batch_warm_start", "full")


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


class _Metered:
    """Each stage run under ``stage(name, fn)`` -> fn's result, with the
    meter's delta recorded as ``wire[name]``."""

    def __init__(self, meter):
        self.meter = meter
        self.wire = {}

    def stage(self, name, fn):
        snap = self.meter.snapshot()
        out = fn()
        self.wire[name] = self.meter.delta(snap)
        return out


def _run_port_stages(cfg, meter=None):
    meter = meter or _Metered(WIRE)
    meter.stage("spectrograms", SpectrogramGenerator(cfg, "cpu").run)
    meter.stage("clustering", ClusterCreator(cfg, "cpu").run)
    return meter.stage("tokenization", SpecTokenizer(cfg, "cpu").run)


def _fused_wire(fresh: Path, root: Path, mode: str) -> dict:
    """The fused clustering and tokenize stages of each package on copies
    of ``fresh`` (native decode), metered -> {"jax", "port": {stage:
    delta}, "port_cfg"}."""
    out = {}
    for side in ("jax", "port"):
        base = root / f"fused_{side}_{mode}"
        shutil.copytree(fresh, base)
        kw = dict(kmeans_mode=mode, fused_pipeline=True,
                  audio_backend="native")
        if side == "jax":
            meter, cfg = _Metered(JAX_WIRE), fixtures.test_config(base, **kw)
            cluster = JaxClusterCreator(cfg)
            tok = lambda rf: JaxSpecTokenizer(cfg, resident_frames=rf)
        else:
            meter, cfg = _Metered(WIRE), port_config(base, **kw)
            cluster = ClusterCreator(cfg, "cpu")
            tok = lambda rf: SpecTokenizer(cfg, "cpu", resident_frames=rf)
            out["port_cfg"] = cfg
        meter.stage("clustering", cluster.run)
        meter.stage("tokenization",
                    tok(cluster.take_resident_frames()).run)
        out[side] = meter.wire
    return out


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """One split workspace, copied before any stage ran (``fresh``), then
    the JAX stages on one copy and the port's on another, each stage
    metered.  The JAX side decodes in python, the port's only decode.
    Then the fused stages of both, metered (``_fused_wire``)."""
    root = tmp_path_factory.mktemp("torch_pipeline")
    fresh = root / "fresh"
    fixtures.make_workspace(fresh)
    jcfg = fixtures.test_config(fresh)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    jax_ws, port_ws = root / "jax", root / "port"
    shutil.copytree(fresh, jax_ws)
    shutil.copytree(fresh, port_ws)
    jcfg = fixtures.test_config(jax_ws, audio_backend="python")
    jax_meter, port_meter = _Metered(JAX_WIRE), _Metered(WIRE)
    jax_meter.stage("spectrograms", JaxSpectrogramGenerator(jcfg).run)
    jax_meter.stage("clustering", JaxClusterCreator(jcfg).run)
    jax_stats = jax_meter.stage("tokenization", JaxSpecTokenizer(jcfg).run)
    pcfg = port_config(port_ws)
    port_stats = _run_port_stages(pcfg, port_meter)
    wire = {"staged": {"jax": jax_meter.wire, "port": port_meter.wire}}
    for mode in KMEANS_MODES:
        wire[f"fused_{mode}"] = _fused_wire(fresh, root, mode)
    return dict(fresh=fresh, jcfg=jcfg, pcfg=pcfg, jax_stats=jax_stats,
                port_stats=port_stats, wire=wire)


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


@pytest.mark.parametrize("run", ["staged"] + [f"fused_{m}"
                                             for m in KMEANS_MODES])
def test_wire_meter_matches_jax(workspaces, run):
    """Each stage's bytes on the port's meter equal the JAX stage's on
    the same workspace and config, exactly.  The one difference by design
    (ROADMAP C10): the fused device feed (``kmeans_mode='full'``) ships the
    int64 rows of each batch's valid frames where the JAX feed ships an
    int32 index of every row's ``frames_max`` frames, so its clustering
    h2d is JAX's less that index plus those rows; where a stage runs a
    device section (the feed's fit, the resident assignment) its seconds
    are > 0."""
    got, ref = (workspaces["wire"][run][side] for side in ("port", "jax"))
    assert got.keys() == ref.keys()
    fix = dict.fromkeys(got, 0)
    if run == "fused_full":
        cfg = workspaces["wire"][run]["port_cfg"]
        gen = SpectrogramGenerator(cfg, "cpu")
        n_train = len(gen.data_split["train"])
        batches = -(-n_train // cfg.device_batch_size)
        frames = sum(len(t) for t in map(np.load, _files(cfg, "tok",
                                                         "train")))
        fix["clustering"] = (frames * 8 - batches * cfg.device_batch_size
                             * gen.frontend.frames_max * 4)
        assert fix["clustering"] != 0
        for stage in got:
            assert got[stage]["device_s"] > 0, stage
    for stage in got:
        assert got[stage]["h2d_mb"] * 2**20 == (ref[stage]["h2d_mb"] * 2**20
                                               + fix[stage]), stage
        assert got[stage]["d2h_mb"] == ref[stage]["d2h_mb"], stage
    assert sum(d["h2d_mb"] for d in got.values()) > 0


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


def _spec_native_matches_jax_native(workspaces, base, cfg):
    """The native decode: the port's spectrograms against the JAX stage's
    with its own native decoder."""
    jax_base = base.parent / "jax_native"
    shutil.copytree(workspaces["fresh"], jax_base)
    jcfg = fixtures.test_config(jax_base, audio_backend="native")
    JaxSpectrogramGenerator(jcfg).run()
    SpectrogramGenerator(cfg, "cpu").run()
    for s in SPLITS:
        jf, pf = _files(jcfg, "spec", s), _files(cfg, "spec", s)
        assert [f.name for f in pf] == [f.name for f in jf] and pf
        for a, b in zip(jf, pf):
            np.testing.assert_allclose(np.load(b), np.load(a), atol=5e-3,
                                       rtol=1e-4)


def _conv_workspaces(workspaces, base):
    """Two copies of the JAX workspace (its spectrograms), the JAX
    clustering stage run with ``use_convolution`` on one: (jax config, the
    JAX creator, its centroids, the port's workspace)."""
    src = Path(workspaces["jcfg"].base_dir)
    jax_base, port_base = base.parent / "jax_conv", base.parent / "port_conv"
    shutil.copytree(src, jax_base)
    shutil.copytree(src, port_base)
    jcfg = fixtures.test_config(jax_base, audio_backend="python",
                                use_convolution=True)
    jcc = JaxClusterCreator(jcfg)
    return jcfg, jcc, jcc.run(), port_base


def _cluster_conv_matches_jax(workspaces, base, cfg):
    """``use_convolution``: with the JAX stage's conv weights carried
    across, the port's centroids within 1e-5 of the JAX stage's, and the
    weights saved beside them."""
    from audio_tokens_tpu_torch.convert import conv_state_dict

    jcfg, jcc, ref, port_base = _conv_workspaces(workspaces, base)
    pcfg = port_config(port_base, use_convolution=True)
    cc = ClusterCreator(pcfg, "cpu")
    cc.conv.load_state_dict(conv_state_dict(jcc.conv.state_dict()))
    got = cc.run()
    assert got.shape == (pcfg.vocab_size, pcfg.n_mels * pcfg.num_kernels)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    saved = np.load(Path(pcfg.centroids_path).with_suffix(".conv.npz"))
    np.testing.assert_array_equal(saved["weight"], jcc.conv.state_dict()[
        "weight"])


def _tokenize_conv_matches_jax(workspaces, base, cfg):
    """``use_convolution``: the port's tokenize stage reads the JAX
    clustering stage's centroids and ``.conv.npz``; tokens equal to the JAX
    stage's except at near-ties."""
    jcfg, _, cents, port_base = _conv_workspaces(workspaces, base)
    pcfg = port_config(port_base, use_convolution=True)
    out = Path(pcfg.centroids_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(jcfg.centroids_path, out)
    shutil.copy(Path(jcfg.centroids_path).with_suffix(".conv.npz"),
                out.with_suffix(".conv.npz"))
    JaxSpecTokenizer(jcfg).run()
    tok = SpecTokenizer(pcfg, "cpu")
    tok.run()
    feats, got, ref = [], [], []
    for s in SPLITS:
        for a, b in zip(_files(jcfg, "tok", s), _files(pcfg, "tok", s)):
            assert a.name == b.name
            spec = np.load(Path(jcfg.dest_spec_path) / s / a.name).T
            feats.append(l2_normalize(tok.conv(torch.from_numpy(
                np.ascontiguousarray(spec)))))
            got.append(torch.from_numpy(np.load(b)))
            ref.append(torch.from_numpy(np.load(a)))
    check_near_ties(torch.cat(feats), torch.from_numpy(cents),
                    torch.cat(got), torch.cat(ref))


def _cluster_default_tier_matches_numpy(workspaces, base, cfg):
    """``kmeans_precision="default"``: the stage's centroids are the
    warm-start schedule run by the numpy version of the TPU's one-pass
    bf16 arithmetic on the stage's own frames."""
    from tests.test_torch_tiers import np_lloyd

    src = Path(workspaces["pcfg"].base_dir)
    shutil.rmtree(base)
    shutil.copytree(src, base)
    assert cfg.max_points_per_centroid is None
    cc = ClusterCreator(cfg, "cpu")
    got = cc.run()
    c = None
    for b in cc._batch_generator(cfg.clustering_batch_size):
        x = b.numpy()
        if c is None:
            rng = np.random.default_rng(cfg.random_seed)
            c = x[rng.choice(len(x), cfg.vocab_size, replace=False)]
        c, _, _ = np_lloyd(x, c, cfg.niter, "default")
    ref = l2_normalize(torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _fused_native_matches_staged(workspaces, base, cfg):
    """The fused mode with the native decoder: the staged port run's
    centroids, its tokens except at near-ties, and a trained model."""
    val_loss, val_metrics = run_pipeline.main(cfg, "cpu")
    assert np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0
    pcfg = workspaces["pcfg"]
    cents = np.load(pcfg.centroids_path)
    np.testing.assert_allclose(np.load(cfg.centroids_path), cents,
                               atol=1e-5, rtol=0)
    feats, got, ref = [], [], []
    for s in SPLITS:
        staged, fused = _files(pcfg, "tok", s), _files(cfg, "tok", s)
        assert [f.name for f in fused] == [f.name for f in staged]
        for a, b in zip(staged, fused):
            spec = np.load(Path(pcfg.dest_spec_path) / s / a.name).T
            feats.append(l2_normalize(torch.from_numpy(
                np.ascontiguousarray(spec))))
            got.append(torch.from_numpy(np.load(b)))
            ref.append(torch.from_numpy(np.load(a)))
    check_near_ties(torch.cat(feats), torch.from_numpy(cents),
                    torch.cat(got), torch.cat(ref))


def _spec_traced_is_unchanged(workspaces, base, cfg):
    """``profile_dir``: each split's rendering traced (one Chrome trace a
    split), the spectrograms bit-equal to the untraced run's."""
    cfg = port_config(base, profile_dir=str(base / cfg.profile_dir))
    SpectrogramGenerator(cfg, "cpu").run()
    traces = sorted(Path(cfg.profile_dir).glob("trace_r0_*.json"))
    assert len(traces) == len(SPLITS)
    for t in traces:
        assert json.loads(t.read_text())["traceEvents"]
    pcfg = workspaces["pcfg"]
    for s in SPLITS:
        pf, got = _files(pcfg, "spec", s), _files(cfg, "spec", s)
        assert [f.name for f in got] == [f.name for f in pf] and got
        for a, b in zip(pf, got):
            np.testing.assert_array_equal(np.load(b), np.load(a))


A6_CHECKS = {
    "spec": _spec_native_matches_jax_native,
    "spec_trace": _spec_traced_is_unchanged,
    "cluster_conv": _cluster_conv_matches_jax,
    "cluster_tier": _cluster_default_tier_matches_numpy,
    "tokenize": _tokenize_conv_matches_jax,
    "pipeline": _fused_native_matches_staged,
}


@pytest.mark.parametrize("stage,override", [
    ("spec", {"audio_backend": "native"}),
    ("spec_trace", {"profile_dir": "trace"}),
    ("cluster_conv", {"use_convolution": True}),
    ("cluster_tier", {"kmeans_precision": "default"}),
    ("tokenize", {"use_convolution": True}),
    ("pipeline", {"fused_pipeline": True, "audio_backend": "native"}),
])
def test_unported_options_refused(workspaces, tmp_path, stage, override):
    """The options once refused (ROADMAP A6, and A7.6's stage traces) run
    and agree with their references (``A6_CHECKS``)."""
    base = tmp_path / "ws"
    shutil.copytree(workspaces["fresh"], base)
    A6_CHECKS[stage](workspaces, base, port_config(base, **override))


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
