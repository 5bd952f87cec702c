"""The port's native decoder binding (``data/native_loader.py``), built
from ``native/audiodec.cpp`` into ``build/native/`` at first use, against
the JAX package's python ``decode_audio`` on the fixtures of
``tests/test_native_loader.py``; its batch layout, int16 wire and stride;
the staged and fused pipelines through it against the port's python
route; and the refusal when the library cannot be built."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.audio_io import decode_audio
from audio_tokens_tpu.ops.mel import reflect_pad_clip
from audio_tokens_tpu_torch.data import native_loader
from audio_tokens_tpu_torch.ops.mel import decode_wire
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from tests import fixtures
from tests.flac_encoder import encode_flac_fixed_order1, encode_flac_verbatim


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_wav_matches_python(tmp_path, rng):
    x = rng.random(22050).astype(np.float32) - 0.5
    fixtures.write_wav(tmp_path / "a.wav", x, sr=22050)
    native = native_loader.decode_file(tmp_path / "a.wav", 22050)
    python, _ = decode_audio(tmp_path / "a.wav", target_sr=22050)
    np.testing.assert_allclose(native, python, atol=1e-7)


def test_stereo_downmix_matches_python(tmp_path, rng):
    x = rng.random(8000).astype(np.float32) - 0.5
    fixtures.write_wav(tmp_path / "s.wav", x, sr=16000, channels=2)
    native = native_loader.decode_file(tmp_path / "s.wav", 16000)
    python, _ = decode_audio(tmp_path / "s.wav", target_sr=16000)
    np.testing.assert_allclose(native, python, atol=1e-6)


def test_resample_matches_python(tmp_path):
    x = np.sin(np.arange(44100) * 0.03).astype(np.float32)
    fixtures.write_wav(tmp_path / "r.wav", x, sr=44100)
    native = native_loader.decode_file(tmp_path / "r.wav", 22050)
    python, _ = decode_audio(tmp_path / "r.wav", target_sr=22050)
    assert len(native) == len(python)
    np.testing.assert_allclose(native, python, atol=2e-5)


def test_flac_matches_python(tmp_path, rng):
    pcm = (rng.random((9000, 2)) * 60000 - 30000).astype(np.int32)
    (tmp_path / "m.flac").write_bytes(
        encode_flac_verbatim(pcm, 22050, block_size=4096))
    native = native_loader.decode_file(tmp_path / "m.flac", 22050)
    python, _ = decode_audio(tmp_path / "m.flac", target_sr=22050)
    np.testing.assert_allclose(native, python, atol=1e-6)
    ramp = np.cumsum(np.array([100, 3, -2, 5, 0, -7, 4, 4, -3, 2, 1, -1]))
    (tmp_path / "f.flac").write_bytes(
        encode_flac_fixed_order1(ramp, 22050, rice_param=2))
    fixed = native_loader.decode_file(tmp_path / "f.flac", 22050)
    np.testing.assert_allclose(fixed * 32768.0, ramp, atol=0.01)


def test_corrupt_file_is_length_minus_one(tmp_path, caplog):
    good = tmp_path / "g.wav"
    fixtures.write_wav(good, fixtures.synth_clip(1, seconds=0.5), sr=22050)
    bad = tmp_path / "b.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunkjunkjunk")
    batch, lengths = native_loader.decode_batch([good, bad], 22050, 22050,
                                                256, n_threads=2)
    assert lengths[0] > 0 and lengths[1] == -1
    assert not batch[1].any()
    with pytest.raises(RuntimeError, match="decode failed"):
        native_loader.decode_file(bad, 22050)


def _clips(tmp_path, n=5, seconds=0.8):
    paths = []
    for i in range(n):
        p = tmp_path / f"c{i}.wav"
        fixtures.write_wav(p, fixtures.synth_clip(i, seconds=seconds),
                           sr=22050)
        paths.append(p)
    return paths


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_batch_layout_and_wire(tmp_path, dtype):
    """Rows are ``reflect_pad_clip`` of the python decode; the int16 wire's
    rows reconstructed by ``decode_wire`` (s / 32768) equal the f32 rows to
    a 16-bit step."""
    sr, clip_samples, n_fft = 22050, 22050, 256
    paths = _clips(tmp_path)
    batch, lengths = native_loader.decode_batch(paths, sr, clip_samples,
                                                n_fft, n_threads=3,
                                                dtype=dtype)
    assert batch.dtype == dtype
    assert batch.shape == (5, clip_samples + n_fft)
    rows = decode_wire(torch.from_numpy(batch)).numpy()
    for i, p in enumerate(paths):
        wav, _ = decode_audio(p, target_sr=sr)
        assert lengths[i] == min(len(wav), clip_samples)
        expect = reflect_pad_clip(wav, clip_samples, n_fft)
        np.testing.assert_allclose(rows[i], expect,
                                   atol=1e-6 if dtype == np.float32
                                   else 1.0 / 32768)


def test_batch_row_len_stride(tmp_path):
    sr, clip_samples, n_fft = 22050, 22050, 256
    paths = _clips(tmp_path, n=3)
    base, lengths = native_loader.decode_batch(paths, sr, clip_samples, n_fft)
    row_min = clip_samples + n_fft
    wide, lengths_w = native_loader.decode_batch(
        paths, sr, clip_samples, n_fft, row_len=row_min + 777)
    assert wide.shape == (3, row_min + 777)
    np.testing.assert_array_equal(lengths, lengths_w)
    np.testing.assert_array_equal(wide[:, :row_min], base)
    assert np.all(wide[:, row_min:] == 0)
    with pytest.raises(ValueError, match="row_len"):
        native_loader.decode_batch(paths, sr, clip_samples, n_fft,
                                   row_len=row_min - 1)


def test_native_refused_when_the_library_cannot_be_built(tmp_path,
                                                         monkeypatch):
    """``audio_backend="native"`` raises when the build fails (a missing
    source); ``"auto"`` falls back to the python decode; ``"python"``
    never builds."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    monkeypatch.setattr(native_loader, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native_loader, "LIB_PATH", tmp_path / "lib.so")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_load_error", None)
    with pytest.raises(RuntimeError, match="source missing"):
        native_loader.select_backend(AudioTokensConfig(audio_backend="native"))
    assert not native_loader.select_backend(
        AudioTokensConfig(audio_backend="auto"))
    assert not native_loader.select_backend(
        AudioTokensConfig(audio_backend="python"))
    assert not (tmp_path / "lib.so").exists()


def test_build_goes_to_build_native_by_rename(tmp_path, monkeypatch):
    """A fresh build lands at its path by ``os.replace`` of a temporary
    file; nothing is written beside the source."""
    src = tmp_path / "src" / "audiodec.cpp"
    src.parent.mkdir()
    shutil.copy(native_loader.ROOT / "native" / "audiodec.cpp", src)
    out = tmp_path / "out" / "libaudiodec.so"
    calls = []
    real = native_loader.os.replace
    monkeypatch.setattr(native_loader.os, "replace",
                        lambda a, b: (calls.append((a, b)), real(a, b)))
    assert native_loader.build(src, out) == out and out.exists()
    assert len(calls) == 1 and calls[0][1] == out
    assert sorted(p.name for p in src.parent.iterdir()) == ["audiodec.cpp"]
    native_loader.build(src, out)  # up to date: no second build
    assert len(calls) == 1


# ---- the stages ------------------------------------------------------------

@pytest.fixture(scope="module")
def python_run(tmp_path_factory):
    """One split fixture workspace and the port's staged run on it with
    the python decode (the reference of the native runs)."""
    from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu.data.splitter import DatasetSplitter
    from audio_tokens_tpu_torch.processors import (
        ClusterCreator,
        SpecTokenizer,
        SpectrogramGenerator,
    )
    from tests.test_torch_pipeline import port_config

    root = tmp_path_factory.mktemp("torch_native")
    fresh = root / "fresh"
    fixtures.make_workspace(fresh)
    jcfg = fixtures.test_config(fresh)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    ref = root / "python"
    shutil.copytree(fresh, ref)
    cfg = port_config(ref, audio_backend="python")
    SpectrogramGenerator(cfg, "cpu").run()
    ClusterCreator(cfg, "cpu").run()
    SpecTokenizer(cfg, "cpu").run()
    return fresh, cfg


def _tokens(cfg, split):
    root = Path(cfg.dest_tokenized_path) / split
    return {p.stem: np.load(p) for p in sorted(root.glob("*.npy"))}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_pipeline_native_matches_python_route(python_run, tmp_path, fused,
                                              wire):
    """The staged stages and the fused pipeline with the native decoder
    (f32 and int16 wire): spectrograms (staged) within 5e-3 dB of the
    python route's, centroids within 1e-5, tokens equal except at
    near-ties against the python run's centroids."""
    from audio_tokens_tpu_torch import run_pipeline
    from audio_tokens_tpu_torch.processors import (
        ClusterCreator,
        SpecTokenizer,
        SpectrogramGenerator,
    )
    from tests.test_torch_pipeline import port_config

    fresh, ref_cfg = python_run
    base = tmp_path / "ws"
    shutil.copytree(fresh, base)
    cfg = port_config(base, audio_backend="native", pcm_wire=wire,
                      fused_pipeline=fused)
    if fused:
        run_pipeline.main(cfg, "cpu")
    else:
        SpectrogramGenerator(cfg, "cpu").run()
        for split in ("train", "validation"):
            root = Path(cfg.dest_spec_path) / split
            files = sorted(root.glob("*.npy"))
            assert files
            for f in files:
                np.testing.assert_allclose(
                    np.load(f), np.load(Path(ref_cfg.dest_spec_path) / split
                                        / f.name), atol=5e-3, rtol=1e-4)
        ClusterCreator(cfg, "cpu").run()
        SpecTokenizer(cfg, "cpu").run()
    cents = np.load(ref_cfg.centroids_path)
    np.testing.assert_allclose(np.load(cfg.centroids_path), cents, atol=1e-5,
                               rtol=0)
    feats, got, ref = [], [], []
    for split in ("train", "validation"):
        a, b = _tokens(ref_cfg, split), _tokens(cfg, split)
        assert sorted(a) == sorted(b) and a
        for ytid in a:
            spec = np.load(Path(ref_cfg.dest_spec_path) / split
                           / f"{ytid}.npy").T
            feats.append(l2_normalize(torch.from_numpy(
                np.ascontiguousarray(spec))))
            got.append(torch.from_numpy(b[ytid]))
            ref.append(torch.from_numpy(a[ytid]))
    check_near_ties(torch.cat(feats), torch.from_numpy(cents),
                    torch.cat(got), torch.cat(ref))


def test_undecodable_clip_is_skipped_and_logged(python_run, tmp_path,
                                                caplog):
    """A corrupt file in the split: the native stage skips it with a log
    line naming it, and writes every other clip."""
    import json
    import logging

    from audio_tokens_tpu_torch.processors import SpectrogramGenerator
    from tests.test_torch_pipeline import port_config

    fresh, _ = python_run
    base = tmp_path / "ws"
    shutil.copytree(fresh, base)
    cfg = port_config(base, audio_backend="native")
    split = json.loads(Path(cfg.split_file).read_text())
    victim = sorted(split["train"])[0]
    path = next(Path(cfg.audio_source_path).rglob(f"{victim}.*"))
    path.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunkjunkjunk")
    with caplog.at_level(logging.INFO):
        SpectrogramGenerator(cfg, "cpu").run()
    written = {p.stem for p in
               (Path(cfg.dest_spec_path) / "train").glob("*.npy")}
    assert victim not in written
    assert written == set(split["train"]) - {victim}
    assert any(victim in r.getMessage() and "skipping" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_iter_wave_batches_match_jax_native(python_run, wire):
    """The device feed's decode-only batches through the native decoder
    equal the JAX stage's native ones (the same C++ source): waveforms in
    the wire's dtype, lengths (-1 on padding rows) and row ytids."""
    from audio_tokens_tpu.processors.spectrogram_generator import (
        SpectrogramGenerator as JaxSpectrogramGenerator,
    )
    from audio_tokens_tpu_torch.processors import SpectrogramGenerator
    from tests.test_torch_pipeline import port_config

    fresh, _ = python_run
    jgen = JaxSpectrogramGenerator(fixtures.test_config(
        fresh, fused_pipeline=True, audio_backend="native", pcm_wire=wire))
    gen = SpectrogramGenerator(port_config(
        fresh, fused_pipeline=True, audio_backend="native", pcm_wire=wire),
        "cpu")
    assert gen.use_native
    ytids = sorted(gen.data_split["train"])
    got = list(gen.iter_wave_batches(ytids))
    ref = list(jgen.iter_wave_batches(ytids))
    assert len(got) == len(ref) > 1
    for (b, ln, rows), (jb, jln, jrows) in zip(got, ref):
        assert b.dtype == (np.int16 if wire == "i16" else np.float32)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(ln, jln)
        assert rows == jrows
