"""Port FusedTokenizer (kernel B1's plain version on the megakernel route,
mel + B2's plain version otherwise) vs the JAX FusedTokenizer's XLA path
(``use_pallas=False``, bit-exact with its interpret-mode megakernel,
tests/test_pallas_tokenizer.py).  Tokens equal except at near-ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

SR, NM, NF, HOP = 22050, 32, 256, 128


def _setup(rng, vocab, **over):
    cents = rng.standard_normal((vocab, NM)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    kw = dict(common_sr=SR, n_mels=NM, n_fft=NF, hop_length=HOP,
              clip_seconds=1.5, vocab_size=vocab, **over)
    jt = JaxTokenizer(JaxConfig(**kw), cents, use_pallas=False)
    pt = FusedTokenizer(AudioTokensConfig(**kw), cents, "cpu")
    clips = [rng.standard_normal(int(SR * s)).astype(np.float32)
             for s in (1.4, 0.9, 1.5)]
    return jt, pt, clips


@pytest.mark.parametrize("vocab", [48, 300])
def test_megakernel_route_matches_jax(rng, vocab):
    jt, pt, clips = _setup(rng, vocab)
    assert pt.kernel is not None
    batch, _ = pt.frontend.prepare_batch(clips)
    ref = np.asarray(jt.tokens_from_padded(jnp.asarray(batch)))
    x = torch.from_numpy(batch)
    got = pt.tokens_from_padded(x)
    assert got.shape == ref.shape and got.dtype == torch.int32
    unit = l2_normalize(pt.kernel.log_mel_plain(x))
    check_near_ties(unit, pt.centroids, got, torch.tensor(ref))


def test_normalize_route_matches_jax(rng):
    """config.normalize: per-clip min-max mel -> B2 (normalize=True)."""
    jt, pt, clips = _setup(rng, 64, normalize=True)
    assert pt.kernel is None  # min-max needs clip-global statistics
    batch, lengths = pt.frontend.prepare_batch(clips)
    ref = np.asarray(jt.tokens_from_padded(jnp.asarray(batch),
                                           jnp.asarray(lengths)))
    x, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    got = pt.tokens_from_padded(x, ln)
    mel = pt.frontend.normalized(x, ln).transpose(1, 2)
    check_near_ties(l2_normalize(mel), pt.centroids, got,
                    torch.tensor(ref))
    with pytest.raises(ValueError, match="requires lengths"):
        pt.tokens_from_padded(x)


def test_tokenize_waveforms_matches_jax(rng):
    jt, pt, clips = _setup(rng, 48)
    ref = jt.tokenize_waveforms(clips)
    got = pt.tokenize_waveforms(clips)
    assert [len(g) for g in got] == [len(r) for r in ref]
    for g, r in zip(got, ref):
        assert g.dtype == np.int64
        assert (g != r).mean() <= 1e-3


def test_megakernel_route_ignores_row_tail_and_decodes_pcm(rng):
    """Rows longer than padded_len: the tail is ignored.  int16 PCM rows
    decode as s/32768 before any compute."""
    _, pt, clips = _setup(rng, 48)
    batch, _ = pt.frontend.prepare_batch(clips)
    base = pt.tokens_from_padded(torch.from_numpy(batch))
    tail = rng.standard_normal((batch.shape[0], 300)).astype(np.float32)
    longer = torch.from_numpy(np.concatenate([batch, tail], axis=1))
    torch.testing.assert_close(pt.tokens_from_padded(longer), base)
    pcm = np.round(np.clip(batch, -1, 1) * 32767).astype(np.int16)
    got = pt.tokens_from_padded(torch.from_numpy(pcm))
    ref = pt.tokens_from_padded(torch.from_numpy(pcm.astype(np.float32)
                                                 / 32768.0))
    torch.testing.assert_close(got, ref)


def test_megakernel_gate(rng):
    """Same gate as the JAX tokenizer: hop | n_fft and no min-max
    normalization."""
    cents = rng.standard_normal((8, NM)).astype(np.float32)
    kw = dict(common_sr=SR, n_mels=NM, clip_seconds=1.0, vocab_size=8)
    assert FusedTokenizer(AudioTokensConfig(n_fft=NF, hop_length=HOP, **kw),
                          cents, "cpu").kernel is not None
    assert FusedTokenizer(AudioTokensConfig(n_fft=NF, hop_length=100, **kw),
                          cents, "cpu").kernel is None
    assert FusedTokenizer(AudioTokensConfig(n_fft=NF, hop_length=HOP,
                                            normalize=True, **kw),
                          cents, "cpu").kernel is None


def test_from_artifacts_loads_centroids(rng, tmp_path):
    cents = rng.standard_normal((8, NM)).astype(np.float32)
    np.save(tmp_path / "centroids.npy", cents)
    cfg = AudioTokensConfig(common_sr=SR, n_mels=NM, n_fft=NF, hop_length=HOP,
                            clip_seconds=1.0, vocab_size=8,
                            centroids_path=tmp_path / "centroids.npy")
    tok = FusedTokenizer.from_artifacts(cfg, "cpu")
    np.testing.assert_array_equal(tok.centroids.numpy(), cents)
