"""The port's recompute options on the CPU against the JAX package's:
``lstm_remat_chunk`` (each direction in time chunks under
``torch.utils.checkpoint``, B3 from the last chunk's carries; JAX
``LSTMLayer._remat_scan``) and ``transformer_remat`` (each encoder block
under ``checkpoint``, its dropout replayed from the caller's generator; JAX
``nn.remat``), under a ``convert.state_dict_for`` weight transplant.
Logits within 1e-5, gradients within atol 2e-5 / rtol 1e-4 (f32 sums in
another order, as ``tests/test_torch_train_lstm.py``); against the same
port model without remat the lstm's logits are bit-equal and the
transformer's dropout trajectory too.  Mirrors JAX
``tests/test_lstm_remat.py`` and ``tests/test_transformer_remat.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
from audio_tokens_tpu.models import get_model as jax_model
from audio_tokens_tpu.utils.seeding import key_for
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import state_dict_for
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.train.objective import weighted_bce

B, T, VOCAB, NCLS = 4, 50, 37, 11
LOGIT_ATOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
LSTM = dict(model_type="lstm", vocab_size=VOCAB, num_classes=NCLS,
            lstm_embed_dim=16, lstm_hidden_dim=24, num_layers=1,
            reference_compat=False)
BERT = dict(model_type="bert", vocab_size=VOCAB, num_classes=7,
            hidden_size=64, num_layers=2, transformer_max_position=24,
            transformer_attention="xla", compute_dtype="float32")


def _data(seed, t=T, n_cls=NCLS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (B, t)).astype(np.int32),
            rng.integers(5, t + 1, (B,)).astype(np.int32),
            rng.integers(0, 2, (B, n_cls)).astype(np.float32))


def _jax_grads(model, params, tokens, lengths, labels):
    """Logits and the gradient of the mean BCE, JAX side."""
    def loss(p):
        lg = model.apply({"params": p}, jnp.asarray(tokens),
                         lengths=None if lengths is None
                         else jnp.asarray(lengths))
        return optax.sigmoid_binary_cross_entropy(lg, labels).mean(), lg

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return np.asarray(logits), jax.device_get(grads)


def _port_grads(model, tokens, lengths, labels, generator=None):
    logits = model(torch.from_numpy(tokens),
                   None if lengths is None else torch.from_numpy(lengths),
                   generator=generator)
    weighted_bce(logits, torch.from_numpy(labels),
                 torch.ones(len(tokens))).backward()
    return (logits.detach(),
            {n: p.grad.clone() for n, p in model.named_parameters()})


@pytest.mark.parametrize("chunk", [7, 16, 50, 128])
def test_lstm_remat_matches_jax_remat(chunk):
    """Chunks that do not divide T (7, 16), one chunk of T (50) and a chunk
    longer than T (128, clamped): the port's remat logits and gradients
    against the JAX remat model's, and its logits bit-equal to its own run
    without remat (``lengths`` ragged: pass-through steps in both
    directions)."""
    tokens, lengths, labels = _data(0)
    jm = jax_model(JaxConfig(**LSTM, lstm_backend="xla",
                             lstm_remat_chunk=chunk))
    params = jm.init(key_for(0, "model_init"), jnp.asarray(tokens),
                     lengths=jnp.asarray(lengths))["params"]
    want_logits, want_grads = _jax_grads(jm, params, tokens, lengths, labels)
    sd = state_dict_for("lstm", jax.device_get(params))
    outs = {}
    for remat in (0, chunk):
        pm = get_model(AudioTokensConfig(**LSTM, lstm_remat_chunk=remat),
                       "cpu", torch.Generator().manual_seed(0))
        pm.load_state_dict(sd)
        outs[remat] = _port_grads(pm, tokens, lengths, labels)
    logits, grads = outs[chunk]
    assert torch.equal(logits, outs[0][0])
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=LOGIT_ATOL)
    # the map carries the JAX gradient tree to the port's names; the JAX
    # loss is the plain mean, the port's weighted mean with unit weights
    for name, ref in state_dict_for("lstm", want_grads).items():
        torch.testing.assert_close(grads[name], ref, **GRAD_TOL, msg=name)


def test_lstm_remat_degenerate_mask_path():
    """``reference_compat`` (lengths None, an all-ones mask) through the
    remat path: the logits of the run without remat."""
    tokens, _, labels = _data(1)
    outs = []
    for chunk in (0, 13):
        pm = get_model(AudioTokensConfig(**LSTM, lstm_remat_chunk=chunk),
                       "cpu", torch.Generator().manual_seed(0))
        outs.append(_port_grads(pm, tokens, None, labels))
    assert torch.equal(outs[1][0], outs[0][0])
    for name, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][name], g, atol=1e-6, rtol=1e-5,
                                   msg=name)


def test_lstm_remat_keeps_no_residuals_under_inference():
    """Without a gradient the remat model takes the plain forward (nothing
    to recompute): the same logits bit for bit."""
    tokens, lengths, _ = _data(2)
    out = []
    for chunk in (0, 16):
        pm = get_model(AudioTokensConfig(**LSTM, lstm_remat_chunk=chunk),
                       "cpu", torch.Generator().manual_seed(0))
        with torch.inference_mode():
            out.append(pm(torch.from_numpy(tokens), torch.from_numpy(lengths)))
    assert torch.equal(out[0], out[1])


def test_transformer_remat_matches_jax_and_plain_model():
    """``transformer_remat`` without dropout: logits and gradients against
    the JAX remat model under transplant, and bit-equal to the port's own
    model without remat."""
    tokens, lengths, labels = _data(3, t=24, n_cls=7)
    jm = jax_model(JaxConfig(**BERT, dropout=0.0, transformer_remat=True))
    params = jm.init(key_for(0, "model_init"), jnp.asarray(tokens),
                     lengths=jnp.asarray(lengths))["params"]
    want_logits, want_grads = _jax_grads(jm, params, tokens, lengths, labels)
    sd = state_dict_for("bert", jax.device_get(params))
    outs = {}
    for remat in (False, True):
        pm = get_model(AudioTokensConfig(**BERT, dropout=0.0,
                                         transformer_remat=remat),
                       "cpu", torch.Generator().manual_seed(0))
        pm.load_state_dict(sd)
        outs[remat] = _port_grads(pm, tokens, lengths, labels)
    np.testing.assert_allclose(outs[True][0].numpy(), want_logits, rtol=0,
                               atol=LOGIT_ATOL)
    for name, ref in state_dict_for("bert", want_grads).items():
        torch.testing.assert_close(outs[True][1][name], ref, **GRAD_TOL,
                                   msg=name)
        assert torch.equal(outs[True][1][name], outs[False][1][name]), name
    assert torch.equal(outs[True][0], outs[False][0])


def test_transformer_remat_dropout_trajectory_is_bit_equal():
    """With live dropout (0.25) the recompute replays the caller's
    generator: one AdamW step from the same weights and the same generator
    seed lands on the same weights bit for bit, and the generator ends
    where the run without remat leaves it."""
    tokens, lengths, labels = _data(4, t=24, n_cls=7)
    outs, after = {}, {}
    for remat in (False, True):
        pm = get_model(AudioTokensConfig(**BERT, dropout=0.25,
                                         transformer_remat=remat),
                       "cpu", torch.Generator().manual_seed(0))
        pm.train()
        opt = torch.optim.AdamW(pm.parameters(), lr=1e-3)
        gen = torch.Generator().manual_seed(7)
        _port_grads(pm, tokens, lengths, labels, gen)
        opt.step()
        outs[remat] = {k: v.clone() for k, v in pm.state_dict().items()}
        after[remat] = gen.get_state()
    for k, v in outs[False].items():
        assert torch.equal(outs[True][k], v), k
    assert torch.equal(after[True], after[False])
