"""Kernel B3's plain version vs the JAX Pallas LSTM kernel (interpret mode),
and the port classifier vs the JAX classifier under a convert.py weight
transplant; tolerance 1e-5 as in tests/test_pallas_lstm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.models.lstm import SimpleLSTMTokenClassifier as JaxLSTM
from audio_tokens_tpu.ops.pallas_lstm import lstm_sequence as jax_lstm_sequence
from audio_tokens_tpu_torch.convert import lstm_state_dict
from audio_tokens_tpu_torch.models.lstm import SimpleLSTMTokenClassifier
from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence

B, T, E, H, C, V = 8, 24, 16, 128, 7, 50


def _mask(rng, masked):
    if not masked:
        return np.ones((T, B), np.float32)
    lens = rng.integers(3, T + 1, (B,))
    return (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sequence_matches_pallas_interpret(rng, reverse, masked):
    xg = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w = rng.uniform(-0.1, 0.1, (H, 4 * H)).astype(np.float32)
    mask = _mask(rng, masked)
    ref_hs, ref_h = jax_lstm_sequence(
        jnp.asarray(xg), jnp.asarray(mask), jnp.asarray(w), reverse,
        jax.lax.Precision.DEFAULT, True)
    hs, h_last = lstm_sequence(torch.from_numpy(xg), torch.from_numpy(mask),
                               torch.from_numpy(w), reverse)
    np.testing.assert_allclose(hs.numpy(), np.asarray(ref_hs),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(ref_h),
                               atol=1e-5, rtol=1e-5)


def _pair(num_layers, seed):
    jm = JaxLSTM(vocab_size=V, embed_dim=E, hidden_dim=H,
                 num_layers=num_layers, num_classes=C, lstm_backend="xla")
    toks = jnp.zeros((B, T), jnp.int32)
    params = jm.init(jax.random.key(seed), toks, lengths=None,
                     deterministic=True)["params"]
    pm = SimpleLSTMTokenClassifier(V, E, H, num_layers, C, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(lstm_state_dict(jax.device_get(params)))
    return jm, params, pm.eval()


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_classifier_matches_jax_under_transplant(rng, num_layers,
                                                 with_lengths):
    jm, params, pm = _pair(num_layers, seed=num_layers)
    toks = rng.integers(0, V, (B, T)).astype(np.int32)
    lens = rng.integers(3, T + 1, (B,)).astype(np.int32)
    ref = jm.apply({"params": params}, jnp.asarray(toks),
                   lengths=jnp.asarray(lens) if with_lengths else None,
                   deterministic=True)
    with torch.inference_mode():
        got = pm(torch.from_numpy(toks),
                 lengths=torch.from_numpy(lens) if with_lengths else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_precomputed_embeddings_path_matches_jax(rng):
    """Float (B, T, E) inputs bypass the embedding table in both packages."""
    jm, params, pm = _pair(1, seed=5)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x), lengths=None,
                   deterministic=True)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_transplant_is_a_copy_of_the_lstm_weights():
    """The kernel boundary keeps the JAX layouts: w_ih (E, 4H), w_hh (H, 4H)
    and bias copy unchanged; only the linear head is transposed."""
    jm, params, pm = _pair(1, seed=7)
    sd = pm.state_dict()
    for d in ("fwd", "bwd"):
        for leaf in ("w_ih", "w_hh", "bias"):
            np.testing.assert_array_equal(
                sd[f"lstm_l0_{d}.{leaf}"].numpy(),
                np.asarray(params[f"lstm_l0_{d}"][leaf]))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  np.asarray(params["fc"]["kernel"]).T)
    np.testing.assert_array_equal(sd["embedding.weight"].numpy(),
                                  np.asarray(params["embedding"]["embedding"]))
    with pytest.raises(KeyError, match="unexpected"):
        lstm_state_dict({"head": {"kernel": np.zeros((2, 2))}})


def test_seeded_init_is_reproducible():
    def make(seed):
        return SimpleLSTMTokenClassifier(
            V, E, H, 1, C, device="cpu",
            generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(1), make(1), make(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lstm_l0_fwd.w_hh"], c["lstm_l0_fwd.w_hh"])
