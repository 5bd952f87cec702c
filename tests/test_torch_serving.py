"""The whole slice: port ServingProgram (plain versions of B1/B2/B3 on the
CPU) vs the JAX ServingProgram with the same centroids and, through
convert.py, the same classifier weights.  Tokens equal except at near-ties,
n_valid equal, probs to rtol 1e-5 / atol 1e-6 (tests/test_export.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
from audio_tokens_tpu.export import ServingProgram as JaxServing
from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import lstm_state_dict
from audio_tokens_tpu_torch.export import ServingProgram
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

SLICE = dict(common_sr=22050, n_mels=32, n_fft=256, hop_length=128,
             clip_seconds=1.5, vocab_size=48, lstm_embed_dim=16,
             lstm_hidden_dim=32, num_classes=7, max_seq_len=272,
             lstm_backend="xla")


def _programs(rng, **over):
    cents = rng.standard_normal((48, 32)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    jcfg, pcfg = JaxConfig(**SLICE, **over), AudioTokensConfig(**SLICE, **over)
    jprog = JaxServing.from_components(
        jcfg, JaxTokenizer(jcfg, cents, use_pallas=False))
    pprog = ServingProgram.from_components(
        pcfg, FusedTokenizer(pcfg, cents, "cpu"),
        lstm_state_dict(jax.device_get(jprog.params)), device="cpu")
    return jprog, pprog


def _unit_features(prog, x, lengths):
    tok = prog.tokenizer
    if tok.kernel is not None:
        return l2_normalize(tok.kernel.log_mel_plain(x))
    return l2_normalize(tok.frontend.normalized(x, lengths).transpose(1, 2))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("reference_compat", [True, False])
def test_slice_matches_jax(rng, normalize, reference_compat):
    jprog, pprog = _programs(rng, normalize=normalize,
                             reference_compat=reference_compat)
    # one clip longer than the window: lengths clamp to clip_samples
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.4, 0.9, 1.5, 1.7)]
    batch, lengths = pprog.tokenizer.frontend.prepare_batch(clips)
    lengths[3] = len(clips[3])
    ref = jprog(jnp.asarray(batch), jnp.asarray(lengths))
    x, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    tokens, n_valid, probs = pprog(x, ln)
    clamped = torch.clamp(ln, max=pprog.config.clip_samples)
    check_near_ties(_unit_features(pprog, x, clamped),
                    pprog.tokenizer.centroids, tokens,
                    torch.tensor(np.asarray(ref[0])))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref[2]),
                               rtol=1e-5, atol=1e-6)


def test_reference_compat_changes_the_answer(rng):
    """The two branches really differ (all-ones mask vs valid lengths), so
    the parity above covers two behaviors, not one."""
    _, compat = _programs(rng, reference_compat=True)
    _, fixed = _programs(np.random.default_rng(0), reference_compat=False)
    fixed.model.load_state_dict(compat.model.state_dict())
    clips = [rng.standard_normal(int(22050 * 0.8)).astype(np.float32)]
    batch, lengths = compat.tokenizer.frontend.prepare_batch(clips)
    a = compat(torch.from_numpy(batch), torch.from_numpy(lengths))[2]
    b = fixed(torch.from_numpy(batch), torch.from_numpy(lengths))[2]
    assert not torch.allclose(a, b)


def test_predict_waveforms_matches_jax(rng):
    jprog, pprog = _programs(rng)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.2, 0.7)]
    ref_toks, ref_probs = jprog.predict_waveforms(clips)
    toks, probs = pprog.predict_waveforms(clips)
    assert [len(t) for t in toks] == [len(t) for t in ref_toks]
    for t, r in zip(toks, ref_toks):
        assert t.dtype == np.int64 and (t != r).mean() <= 1e-3
    np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)


def test_program_and_tokenizer_devices_must_match(rng):
    cfg = AudioTokensConfig(**SLICE)
    tok = FusedTokenizer(cfg, np.zeros((48, 32), np.float32), "cpu")
    with pytest.raises(ValueError, match="tokenizer on cpu"):
        ServingProgram.from_components(cfg, tok, device="meta")
