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


def _frames_pair(n_mels, embed_dim):
    """The JAX and the port lstm for ``use_precomputed_embeddings=True``,
    both through their ``get_model``, at n_mels != lstm_embed_dim; the
    port's weights transplanted from the JAX tree."""
    from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
    from audio_tokens_tpu.models.registry import get_model as jax_get_model
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model

    kw = dict(model_type="lstm", use_precomputed_embeddings=True,
              n_mels=n_mels, lstm_embed_dim=embed_dim, lstm_hidden_dim=H,
              num_layers=1, num_classes=C, vocab_size=V)
    jm = jax_get_model(JaxConfig(**kw))
    params = jm.init(jax.random.key(3), jnp.zeros((B, T, n_mels)),
                     lengths=None, deterministic=True)["params"]
    pm = get_model(AudioTokensConfig(**kw), "cpu",
                   torch.Generator().manual_seed(0))
    sd = lstm_state_dict(jax.device_get(params))
    missing, unexpected = pm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return jm, params, pm.eval()


@pytest.mark.parametrize("with_lengths", [False, True])
def test_precomputed_frames_lstm_matches_jax_through_get_model(rng,
                                                               with_lengths):
    """The lstm on mel frames of width n_mels (12) != lstm_embed_dim (16):
    layer 0's w_ih has n_mels rows, no embedding table exists, and the
    logits equal the JAX model's within 1e-5."""
    n_mels = 12
    jm, params, pm = _frames_pair(n_mels, embed_dim=16)
    assert "embedding" not in params
    assert not any(n.startswith("embedding") for n, _ in
                   pm.named_parameters())
    assert tuple(pm.lstm_l0_fwd.w_ih.shape) == (n_mels, 4 * H)
    x = rng.standard_normal((B, T, n_mels)).astype(np.float32)
    lens = rng.integers(3, T + 1, (B,)).astype(np.int32)
    ref = jm.apply({"params": params}, jnp.asarray(x),
                   lengths=jnp.asarray(lens) if with_lengths else None,
                   deterministic=True)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x),
                 lengths=torch.from_numpy(lens) if with_lengths else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="float frames"):
        pm(torch.zeros((B, T), dtype=torch.int32))


def test_trainer_steps_on_raw_stft_frames(tmp_path):
    """The port's Trainer on a RawSTFTDataset workspace (mel frames of
    width n_mels 32, lstm_embed_dim 16): one training step on the CPU, a
    finite validation loss, and no embedding parameter in the model."""
    import json
    from pathlib import Path

    from audio_tokens_tpu_torch.train.trainer import Trainer
    from tests import token_corpus

    token_corpus.make_token_corpus(tmp_path)
    cfg = token_corpus.port_config(
        tmp_path, dataset_type="RawSTFTDataset",
        use_precomputed_embeddings=True, max_train_steps=1, epochs=1,
        checkpoint_dir=str(tmp_path / "ckpt"))
    assert cfg.n_mels != cfg.lstm_embed_dim
    split = json.loads(Path(cfg.split_file).read_text())
    gen = np.random.default_rng(4)
    for name, ytids in split.items():
        out = Path(cfg.source_spec_path) / name
        out.mkdir(parents=True, exist_ok=True)
        for ytid in ytids:
            n = int(gen.integers(20, 2 * cfg.max_seq_len))
            np.save(out / f"{ytid}.npy",
                    gen.standard_normal((cfg.n_mels, n)).astype(np.float32))
    trainer = Trainer(cfg, "cpu")
    assert trainer.model.embedding is None
    assert tuple(trainer.model.lstm_l0_fwd.w_ih.shape) == (
        cfg.n_mels, 4 * cfg.lstm_hidden_dim)
    before = trainer.model.lstm_l0_fwd.w_ih.detach().clone()
    val_loss, metrics = trainer.run()
    assert np.isfinite(val_loss) and 0.0 <= metrics["mAP"] <= 1.0
    assert not torch.equal(before, trainer.model.lstm_l0_fwd.w_ih.detach())
