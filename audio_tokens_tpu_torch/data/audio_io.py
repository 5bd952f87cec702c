"""Host-side audio decode: RIFF/WAV parser + polyphase resampler.

A copy of ``audio_tokens_tpu/data/audio_io.py`` (numpy only), held bit-equal
to the original by ``tests/test_torch_audio_io.py``.

The reference delegates decode/resample to torchaudio's C++ backends
(reference: processors/spectrogram_generator.py:99,117-121).  This python
decode is the stages' ``audio_backend="python"`` route; ``"native"`` and
``"auto"`` (where the library builds) take the C++ decoder under
``native/`` through ``data/native_loader.py`` (``select_backend`` makes
the choice and logs it), as the JAX package does.

Decode returns float32 in [-1, 1].  Multi-channel audio is downmixed to mono
by the channel mean, matching the reference's ``convert_to_mono``
(reference: processors/spectrogram_generator.py:109-115).
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


class AudioDecodeError(RuntimeError):
    pass


def decode_clip(config, path) -> Optional[np.ndarray]:
    """Decode one clip for a pipeline stage with the shared skip-and-log
    semantics: undecodable, too-short, or non-finite waveforms return None
    (the reference skips such clips; a NaN/Inf waveform would otherwise
    produce a NaN spectrogram that the staged pipeline's screen drops)."""
    import logging

    logger = logging.getLogger(__name__)
    try:
        wave, _ = decode_audio(path, target_sr=config.common_sr)
    except Exception as e:  # skip-and-log, like the reference
        logger.info("skipping %s: %s", path, e)
        return None
    if len(wave) < config.n_fft:
        logger.info("skipping %s: too short (%d samples)", path, len(wave))
        return None
    if not np.isfinite(wave).all():
        logger.info("skipping %s: non-finite samples", path)
        return None
    return wave


def write_pcm_wav(path, samples: np.ndarray, sr: int,
                  channels: int = 1) -> None:
    """Write int16 PCM WAV via stdlib (shared by tools/tests fixtures)."""
    import wave as _wave

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    if channels > 1 and pcm.ndim == 1:
        pcm = np.stack([pcm] * channels, axis=1)
    with _wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and IEEE float 32/64.

    Returns (samples (n, channels) float32 in [-1,1], sample_rate).
    """
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError(f"not a RIFF/WAVE file: {path}")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == 0xFFFE:
                # WAVE_FORMAT_EXTENSIBLE: real format code is the first two
                # bytes of the SubFormat GUID at offset 24
                if len(body) < 26:
                    raise AudioDecodeError(
                        f"truncated WAVE_FORMAT_EXTENSIBLE fmt chunk: {path}"
                    )
                (sub,) = struct.unpack_from("<H", body, 24)
                fmt = (sub,) + fmt[1:]
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise AudioDecodeError(f"missing fmt/data chunk: {path}")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if channels < 1:
        raise AudioDecodeError(f"bad channel count {channels}: {path}")

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / 8388608.0
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}: {path}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            dtype = "<f4"
        elif bits == 64:
            dtype = "<f8"
        else:  # half-float / corrupt fmt: reject like the native decoder
            raise AudioDecodeError(
                f"unsupported float bit depth {bits}: {path}")
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise AudioDecodeError(f"unsupported WAV format {audio_format}: {path}")

    n = len(x) // channels
    return x[: n * channels].reshape(n, channels), sample_rate


def to_mono(samples: np.ndarray) -> np.ndarray:
    """(n, channels) -> (n,) by channel mean (reference behavior)."""
    if samples.ndim == 1:
        return samples
    if samples.shape[1] == 1:
        return samples[:, 0]
    return samples.mean(axis=1, dtype=np.float32)


# ----------------------------------------------------------------------
# Polyphase windowed-sinc resampler (torchaudio 'sinc_interp_hann' semantics:
# lowpass_filter_width=6, rolloff=0.99, gcd-reduced rational rate).
# ----------------------------------------------------------------------

_KERNEL_CACHE: dict = {}


def _resample_kernel(orig: int, new: int, lowpass_width: int = 6, rolloff: float = 0.99):
    """(kernels (new, width), width, orig, new) for gcd-reduced rates."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_width * orig / base_freq))
    # times at which each output-phase tap looks at the input, in input units
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_width, lowpass_width)
    window = np.cos(t * np.pi / lowpass_width / 2) ** 2
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernels.astype(np.float32), width, orig, new


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Rational-rate polyphase resample of a 1-D signal (host numpy)."""
    if orig_sr == new_sr:
        return x.astype(np.float32, copy=False)
    key = (orig_sr, new_sr)
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = _resample_kernel(orig_sr, new_sr)
    kernels, width, orig, new = _KERNEL_CACHE[key]

    n_in = len(x)
    target_len = int(math.ceil(new_sr * n_in / orig_sr))
    xp = np.pad(x.astype(np.float32), (width, width + orig))
    n_blocks = int(math.ceil(n_in / orig))
    taps = kernels.shape[1]
    # gather strided frames: block b covers xp[b*orig : b*orig + taps]
    strided = np.lib.stride_tricks.sliding_window_view(xp, taps)[::orig][:n_blocks]
    out = strided @ kernels.T  # (n_blocks, new)
    return out.reshape(-1)[:target_len]


def find_audio_file(config, ytid: str) -> Optional[Path]:
    """Probe ``{audio_source_path}/{set}/{ytid[:2]}/{ytid}.flac`` (then .wav)
    across the configured source sets — the reference's file layout
    (reference: processors/spectrogram_generator.py:87-95)."""
    for source_set in config.audio_source_sets:
        base = Path(config.audio_source_path) / source_set / ytid[:2]
        for ext in (".flac", ".wav"):
            p = base / f"{ytid}{ext}"
            if p.exists():
                return p
    return None


def decode_audio(path, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode any supported container to mono float32, optionally resampled."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        samples, sr = read_wav(path)
    elif suffix == ".flac":
        from audio_tokens_tpu_torch.data import flac

        samples, sr = flac.read_flac(path)
    else:
        raise AudioDecodeError(f"unsupported container {suffix}: {path}")
    mono = to_mono(samples)
    if target_sr is not None and sr != target_sr:
        mono = resample(mono, sr, target_sr)
        sr = target_sr
    return mono, sr
