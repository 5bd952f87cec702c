"""Port mel frontend (plain PyTorch) vs the JAX MelFrontend on the same
padded batches, at tests/test_mel.py's tolerance (atol 5e-3 dB, rtol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops.mel import MelFrontend as JaxMel
from audio_tokens_tpu_torch.ops.mel import MelFrontend, decode_wire

SR, N_MELS, CLIP = 22050, 32, 1.5


def _pair(n_fft, hop):
    kw = dict(sample_rate=SR, n_mels=N_MELS, n_fft=n_fft, hop_length=hop,
              clip_samples=int(SR * CLIP))
    return JaxMel(**kw), MelFrontend("cpu", **kw)


def _clips(rng):
    return [rng.standard_normal(int(SR * s)).astype(np.float32)
            for s in (1.4, 0.9, 1.5)]


@pytest.mark.parametrize("n_fft,hop", [(256, 128), (256, 100)])
def test_mel_frames_match_jax(rng, n_fft, hop):
    """hop | n_fft (the JAX package's GEMM path) and hop not dividing n_fft
    (its strided-conv path): the port frames with unfold for both."""
    jm, pm = _pair(n_fft, hop)
    batch, lengths = pm.prepare_batch(_clips(rng))
    jb, jl = jm.prepare_batch(_clips(np.random.default_rng(0)))
    np.testing.assert_array_equal(batch, jb)
    np.testing.assert_array_equal(lengths, jl)
    ref = np.asarray(jm.mel_frames(jnp.asarray(batch)))
    got = pm.mel_frames(torch.from_numpy(batch)).numpy()
    assert got.shape == ref.shape == (3, pm.frames_max, N_MELS)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=1e-4)
    # (B, n_mels, T) artifact layout
    np.testing.assert_allclose(pm(torch.from_numpy(batch)).numpy(),
                               np.asarray(jm(jnp.asarray(batch))),
                               atol=5e-3, rtol=1e-4)


def test_normalized_matches_jax(rng):
    jm, pm = _pair(256, 128)
    batch, lengths = pm.prepare_batch(_clips(rng))
    ref = np.asarray(jm.normalized(jnp.asarray(batch), jnp.asarray(lengths)))
    got = pm.normalized(torch.from_numpy(batch),
                        torch.from_numpy(lengths)).numpy()
    # min-max scaled dB: the 5e-3 dB tolerance over a ~100 dB range
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(
        pm.frame_counts(torch.from_numpy(lengths)).numpy(),
        np.asarray(jm.frame_counts(jnp.asarray(lengths))))


def test_normalized_silence_is_zero_not_nan():
    _, pm = _pair(256, 128)
    batch, lengths = pm.prepare_batch([np.zeros(int(SR * 1.0), np.float32)])
    out = pm.normalized(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert torch.isfinite(out).all() and (out == 0).all()


def test_decode_wire_int16_matches_jax(rng):
    from audio_tokens_tpu.ops.mel import decode_wire as jax_decode

    pcm = rng.integers(-32768, 32767, (2, 500)).astype(np.int16)
    np.testing.assert_array_equal(decode_wire(torch.from_numpy(pcm)).numpy(),
                                  np.asarray(jax_decode(jnp.asarray(pcm))))
    f = torch.ones(3)
    assert decode_wire(f) is f
