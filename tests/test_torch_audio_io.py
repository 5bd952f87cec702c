"""The port's copies of ``data/audio_io.py`` and ``data/flac.py`` are
bit-equal to the JAX package's originals on the same files: the fixture's
mono and stereo wavs, FLAC streams from ``tests/flac_encoder.py``, and
resamples from 16 kHz and 44.1 kHz to 22,050 Hz."""

from pathlib import Path

import numpy as np
import pytest

from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
from audio_tokens_tpu.data import audio_io as jax_io
from audio_tokens_tpu.data import flac as jax_flac
from audio_tokens_tpu_torch.config import AudioTokensConfig as PortConfig
from audio_tokens_tpu_torch.data import audio_io as port_io
from audio_tokens_tpu_torch.data import flac as port_flac
from tests import fixtures
from tests.flac_encoder import encode_flac_fixed_order1, encode_flac_verbatim


def _equal(a, b):
    """Same dtype, shape and bits (tuples element by element)."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
        return
    assert a == b


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """The fixture corpus's clips (every 6th stereo), a 44.1 kHz and a
    16 kHz wav, and three FLAC streams."""
    base = tmp_path_factory.mktemp("audio")
    fixtures.make_audio(base / "audioset", n_clips=7)
    rng = np.random.default_rng(3)
    for sr in (44100, 16000):
        fixtures.write_wav(base / f"tone{sr}.wav",
                           fixtures.synth_clip(1, seconds=0.5, sr=sr), sr=sr)
    pcm = (rng.random(5000) * 60000 - 30000).astype(np.int32)
    (base / "mono.flac").write_bytes(encode_flac_verbatim(pcm, 22050))
    pcm2 = (rng.random((9000, 2)) * 60000 - 30000).astype(np.int32)
    (base / "stereo.flac").write_bytes(
        encode_flac_verbatim(pcm2, 44100, block_size=4096))
    ramp = np.cumsum(np.array([100, 3, -2, 5, 0, -7, 4, 4, -3, 2, 1, -1]))
    (base / "rice.flac").write_bytes(
        encode_flac_fixed_order1(ramp, 22050, rice_param=2))
    return base


def _wavs(base: Path):
    return sorted((base / "audioset").rglob("*.wav"))


def test_fixture_has_mono_and_stereo_wavs(audio_dir):
    channels = {port_io.read_wav(p)[0].shape[1] for p in _wavs(audio_dir)}
    assert channels == {1, 2}


@pytest.mark.parametrize("fn", ["read_wav", "decode_audio"])
def test_wav_decode_bit_equal(audio_dir, fn):
    for path in _wavs(audio_dir):
        _equal(getattr(port_io, fn)(path), getattr(jax_io, fn)(path))


def test_to_mono_bit_equal(audio_dir):
    for path in _wavs(audio_dir):
        samples, _ = jax_io.read_wav(path)
        _equal(port_io.to_mono(samples), jax_io.to_mono(samples))


@pytest.mark.parametrize("name", ["mono.flac", "stereo.flac", "rice.flac"])
def test_flac_bit_equal(audio_dir, name):
    path = audio_dir / name
    _equal(port_flac.read_flac(path), jax_flac.read_flac(path))
    _equal(port_io.decode_audio(path, target_sr=22050),
           jax_io.decode_audio(path, target_sr=22050))


@pytest.mark.parametrize("sr", [16000, 44100])
def test_resample_to_22050_bit_equal(audio_dir, sr):
    x = fixtures.synth_clip(2, seconds=0.75, sr=sr)
    _equal(port_io.resample(x, sr, 22050), jax_io.resample(x, sr, 22050))
    path = audio_dir / f"tone{sr}.wav"
    _equal(port_io.decode_audio(path, target_sr=22050),
           jax_io.decode_audio(path, target_sr=22050))


def test_decode_clip_and_find_audio_file_equal(audio_dir, tmp_path):
    kw = dict(base_dir=str(audio_dir), n_fft=256)
    pcfg, jcfg = PortConfig(**kw), JaxConfig(**kw)
    for i in range(7):
        ytid = fixtures.ytid_for(i)
        path = port_io.find_audio_file(pcfg, ytid)
        assert path == jax_io.find_audio_file(jcfg, ytid) is not None
        _equal(port_io.decode_clip(pcfg, path), jax_io.decode_clip(jcfg, path))
    assert port_io.find_audio_file(pcfg, "missing000") is None
    # too short and undecodable clips are skipped (None) by both
    fixtures.write_wav(tmp_path / "short.wav", np.zeros(100, np.float32))
    (tmp_path / "bad.wav").write_bytes(b"not a wav")
    for name in ("short.wav", "bad.wav"):
        assert port_io.decode_clip(pcfg, tmp_path / name) is None
        assert jax_io.decode_clip(jcfg, tmp_path / name) is None


def test_write_pcm_wav_bit_equal(tmp_path):
    x = fixtures.synth_clip(5, seconds=0.3)
    port_io.write_pcm_wav(tmp_path / "p.wav", x, 22050, channels=2)
    jax_io.write_pcm_wav(tmp_path / "j.wav", x, 22050, channels=2)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_undecodable_containers_raise_in_both(tmp_path):
    (tmp_path / "x.mp3").write_bytes(b"\0" * 16)
    (tmp_path / "bad.flac").write_bytes(b"RIFF-not-a-flac")
    with pytest.raises(port_io.AudioDecodeError):
        port_io.decode_audio(tmp_path / "x.mp3")
    with pytest.raises(port_flac.FlacError):
        port_flac.read_flac(tmp_path / "bad.flac")
    with pytest.raises(jax_flac.FlacError):
        jax_flac.read_flac(tmp_path / "bad.flac")
