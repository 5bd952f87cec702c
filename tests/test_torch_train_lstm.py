"""The training side of kernels B3 and B4 on the CPU: their plain versions
against the JAX Pallas kernels in interpret mode, ``lstm_sequence``'s
autograd (``atk::lstm_fwd`` joined to ``atk::lstm_bwd`` and ``atk::lstm_dw``)
under ``gradcheck``, and the port classifier's gradients against ``jax.grad`` of
the JAX classifier under a ``convert.py`` weight transplant.  Tolerances:
atol 2e-5 / rtol 1e-4 for gradients (the ``tests/test_pallas_lstm.py``
bound: f32 sums in another order through T steps), 1e-5 for forward
values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.models.lstm import SimpleLSTMTokenClassifier as JaxLSTM
from audio_tokens_tpu.ops.pallas_lstm import _lstm_bwd_call, _lstm_fwd_call
from audio_tokens_tpu.train.objective import make_loss_fn
from audio_tokens_tpu_torch.convert import lstm_state_dict
from audio_tokens_tpu_torch.models.lstm import SimpleLSTMTokenClassifier
from audio_tokens_tpu_torch.ops.cuda_lstm import (
    lstm_dw_hh, lstm_sequence, lstm_sequence_bwd,
    lstm_sequence_bwd_plain, lstm_sequence_fwd, lstm_sequence_fwd_plain)
from audio_tokens_tpu_torch.train.objective import weighted_bce

B, T, E, H, C, V = 8, 24, 16, 32, 7, 50
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
PREC = jax.lax.Precision.DEFAULT


def _mask(rng, masked, t=T, b=B):
    if not masked:
        return np.ones((t, b), np.float32)
    lens = rng.integers(min(3, t), t + 1, (b,))
    return (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)


def _inputs(rng, masked, t=T, b=B, h=H):
    xg = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (h, 4 * h)).astype(np.float32)
    return xg, _mask(rng, masked, t, b), w


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_residuals_match_pallas_interpret(rng, reverse, masked):
    """hs, post-activation gates, the masked cell carry and h_last."""
    xg, mask, w = _inputs(rng, masked)
    ref = _lstm_fwd_call(jnp.asarray(xg), jnp.asarray(mask), jnp.asarray(w),
                         reverse, PREC, True)
    got = lstm_sequence_fwd(torch.from_numpy(xg), torch.from_numpy(mask),
                            torch.from_numpy(w), reverse, residuals=True)
    for name, g, r in zip(("hs", "gates", "c", "h_last"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# (T, B, H): the module's shape, then the edges of the card kernel B4's
# partition that its card tests use: B not a multiple of a block's batch
# rows (33), H not a multiple of its 8 or 16 units (36, 20), T 2
BWD_SHAPES = [(T, B, H), (6, 33, 36), (2, 5, 20)]


@pytest.mark.parametrize("tbh", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_pallas_interpret(rng, reverse, masked, tbh):
    """dxg and dw_hh of the plain backward vs ``_bwd_kernel`` on the same
    residuals and upstream gradients; and ``lstm_dw_hh`` on CPU tensors
    (its plain version) vs the same ``dw`` from ``_bwd_kernel``'s dxg."""
    t, b, h = tbh
    xg, mask, w = _inputs(rng, masked, t, b, h)
    hs, gates, c, _ = _lstm_fwd_call(jnp.asarray(xg), jnp.asarray(mask),
                                     jnp.asarray(w), reverse, PREC, True)
    dhs = rng.standard_normal((t, b, h)).astype(np.float32)
    dh_last = rng.standard_normal((b, h)).astype(np.float32)
    ref_dxg, ref_dw = _lstm_bwd_call(
        jnp.asarray(dhs), jnp.asarray(dh_last), gates, c, hs,
        jnp.asarray(mask), jnp.asarray(w), reverse, PREC, True)
    dxg, dw = lstm_sequence_bwd(
        torch.from_numpy(dhs), torch.from_numpy(dh_last),
        *(torch.from_numpy(np.array(a)) for a in (gates, c, hs)),
        torch.from_numpy(mask), torch.from_numpy(w), reverse)
    np.testing.assert_allclose(dxg.numpy(), np.asarray(ref_dxg), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), **GRAD_TOL)
    dw_alone = lstm_dw_hh(torch.from_numpy(np.array(hs)),
                          torch.from_numpy(np.array(ref_dxg)), reverse)
    np.testing.assert_allclose(dw_alone.numpy(), np.asarray(ref_dw),
                               **GRAD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_dw_hh_of_one_step_is_zero(rng, reverse):
    """T 1: the only step's h_prev is the zero state, so dw_hh is all zero,
    from ``lstm_dw_hh`` and from the whole plain backward."""
    xg, mask, w = _inputs(rng, False, 1, 5, 20)
    hs, gates, c, _ = lstm_sequence_fwd(torch.from_numpy(xg),
                                        torch.from_numpy(mask),
                                        torch.from_numpy(w), reverse,
                                        residuals=True)
    dxg = torch.from_numpy(rng.standard_normal((1, 5, 80)).astype(np.float32))
    zeros = torch.zeros((20, 80))
    assert torch.equal(lstm_dw_hh(hs, dxg, reverse), zeros)
    _, dw = lstm_sequence_bwd(torch.ones_like(hs), torch.ones((5, 20)),
                              gates, c, hs, torch.from_numpy(mask),
                              torch.from_numpy(w), reverse)
    assert torch.equal(dw, zeros)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_sequence_gradcheck_float64(reverse):
    """``lstm_sequence``'s hand-written backward against finite differences
    in float64, with a ragged mask (pass-through steps in both
    directions)."""
    gen = torch.Generator().manual_seed(1)
    t, b, h = 5, 2, 4
    xg = torch.randn((t, b, 4 * h), generator=gen, dtype=torch.float64,
                     requires_grad=True)
    w = (0.5 * torch.randn((h, 4 * h), generator=gen, dtype=torch.float64)
         ).requires_grad_()
    mask = torch.tensor([[1, 1], [1, 1], [1, 1], [0, 1], [0, 1]],
                        dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x, ww: lstm_sequence(x, mask, ww, reverse), (xg, w))


def test_plain_backward_is_autograd_of_plain_forward(rng):
    """The hand-written backward equals torch autograd through the plain
    forward loop (float64: the two differ only by summation order)."""
    xg, mask, w = (torch.from_numpy(a).double() for a in _inputs(rng, True))
    xg.requires_grad_()
    w.requires_grad_()
    dhs = torch.from_numpy(rng.standard_normal((T, B, H)))
    dh_last = torch.from_numpy(rng.standard_normal((B, H)))
    for reverse in (False, True):
        hs, gates, c, h_last = lstm_sequence_fwd_plain(xg, mask, w, reverse)
        ref = torch.autograd.grad((hs * dhs).sum() + (h_last * dh_last).sum(),
                                  (xg, w))
        got = lstm_sequence_bwd_plain(dhs, dh_last, gates.detach(),
                                      c.detach(), hs.detach(), mask,
                                      w.detach(), reverse)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=1e-12, rtol=1e-10)


def test_no_grad_forward_skips_residuals_and_autograd(rng):
    """Serving (no gradient needed) takes the forward without residuals and
    builds no graph; training goes through the autograd registered on
    ``atk::lstm_fwd``."""
    xg, mask, w = (torch.from_numpy(a) for a in _inputs(rng, True))
    hs, gates, c, h_last = lstm_sequence_fwd(xg, mask, w)
    assert gates is None and c is None
    with torch.inference_mode():
        hs_i, h_i = lstm_sequence(xg, mask, w)
    assert hs_i.grad_fn is None
    torch.testing.assert_close(hs_i, hs, atol=0, rtol=0)
    w.requires_grad_()
    hs_g, h_g = lstm_sequence(xg, mask, w)
    assert "atk_lstm_fwd" in type(hs_g.grad_fn).__name__
    torch.testing.assert_close(h_g.detach(), h_last, atol=0, rtol=0)


def _pair(num_layers, seed):
    jm = JaxLSTM(vocab_size=V, embed_dim=E, hidden_dim=H,
                 num_layers=num_layers, num_classes=C, lstm_backend="xla")
    params = jm.init(jax.random.key(seed), jnp.zeros((B, T), jnp.int32),
                     lengths=None, deterministic=True)["params"]
    pm = SimpleLSTMTokenClassifier(V, E, H, num_layers, C, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(lstm_state_dict(jax.device_get(params)))
    return jm, params, pm


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_classifier_gradients_match_jax_under_transplant(rng, num_layers,
                                                         with_lengths):
    """Loss and every parameter's gradient of the weighted BCE, the port
    (the plain backward of ``lstm_sequence``'s autograd) vs
    ``jax.value_and_grad`` of the JAX classifier; one padded row (weight 0)
    as in a partial last batch."""
    jm, params, pm = _pair(num_layers, seed=10 + num_layers)
    toks = rng.integers(0, V, (B, T)).astype(np.int32)
    lens = rng.integers(3, T + 1, (B,)).astype(np.int32)
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    row_w = np.ones(B, np.float32)
    row_w[-1] = 0.0
    loss_fn = make_loss_fn(jm, use_lengths=with_lengths)
    (ref_loss, _), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(labels),
        jnp.asarray(row_w), None, True)
    logits = pm(torch.from_numpy(toks),
                torch.from_numpy(lens) if with_lengths else None)
    loss = weighted_bce(logits, torch.from_numpy(labels),
                        torch.from_numpy(row_w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-6)
    ref = lstm_state_dict(jax.device_get(ref_grads))
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_dropout_needs_a_generator_and_follows_it():
    pm = SimpleLSTMTokenClassifier(V, E, H, 1, C, dropout=0.5, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, V, (B, T), generator=torch.Generator()
                         .manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        pm(toks)
    a = pm(toks, generator=torch.Generator().manual_seed(5))
    b = pm(toks, generator=torch.Generator().manual_seed(5))
    c = pm(toks, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    pm.eval()  # no dropout, no generator needed
    torch.testing.assert_close(pm(toks), pm(toks), atol=0, rtol=0)
