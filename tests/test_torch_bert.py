"""The port's bert classifier (``models/transformer.py``) on the CPU against
the JAX package's ``TransformerClassifier`` under a ``convert.
bert_state_dict`` weight transplant, at hidden 128, 2 heads of 64, 2 layers.

The ``"flash"`` route of the JAX model runs the library Pallas kernel in
interpret mode; the port's runs B5's plain version.  Logits are compared
whole at f32 within 1e-5.  A row of length 0 is compared only where T is a
multiple of the JAX module's 256-wide flash block: elsewhere its padding
adds zero keys to that row's softmax, which the port (no padding) does not
have."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audio_tokens_tpu.models.transformer import (
    FlashSelfAttention as JaxFlashSelfAttention,
    TransformerClassifier as JaxBert)
from audio_tokens_tpu.train.objective import make_loss_fn
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import bert_state_dict
from audio_tokens_tpu_torch.models import get_model, registry, transformer
from audio_tokens_tpu_torch.models.transformer import (FlashSelfAttention,
                                                       TransformerClassifier)
from audio_tokens_tpu_torch.train.objective import weighted_bce

B, H, LAYERS, V, C = 3, 128, 2, 50, 7
ATOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)  # f32 sums in another order


def interpret():
    """Run Pallas kernels by the generic interpreter (``pallas_call(...,
    interpret=True)``, as the JAX package's own kernel tests run them): the
    kernel becomes plain JAX ops.  TPU interpret mode (the default params)
    runs the kernel through host callbacks, and an op dispatched while those
    run can deadlock the CPU device queue."""
    return pltpu.force_tpu_interpret_mode(True)


def _jax_model(impl, max_position, dtype=jnp.float32):
    return JaxBert(vocab_size=V, num_layers=LAYERS, num_classes=C,
                   hidden_size=H, max_position=max_position, dropout=0.0,
                   compute_dtype=dtype, attention_impl=impl)


def _jax_logits(model, params, x, lengths):
    """model.apply in eval mode, jitted, kernels in interpret mode."""
    fn = jax.jit(lambda p, x, ln: model.apply({"params": p}, x, lengths=ln,
                                              deterministic=True))
    with interpret():
        return np.asarray(fn(params, jnp.asarray(x), lengths))


def _port_model(impl, max_position, params, dtype=torch.float32):
    pm = TransformerClassifier(V, LAYERS, C, H, max_position, 0.0, dtype,
                               impl, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(bert_state_dict(jax.device_get(params)))
    return pm.eval()


@pytest.fixture(scope="module")
def windows():
    """Per window: the JAX params (drawn once, shared by both routes) and
    600 input tokens."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, V, (B, 600)).astype(np.int32)
    out = {}
    for window in (512, 600):
        params = _jax_model("xla", window).init(
            jax.random.key(window), jnp.asarray(toks), lengths=None,
            deterministic=True)["params"]
        out[window] = (params, toks)
    return out


def test_bert_state_dict_round_trip(windows):
    """Every JAX parameter lands on one port parameter of the same size,
    the port's state_dict names are exactly those, and a query projection
    computes what JAX's DenseGeneral does."""
    params, _ = windows[512]
    sd = bert_state_dict(jax.device_get(params))
    pm = _port_model("xla", 512, params)
    assert sorted(sd) == sorted(pm.state_dict())
    flat = jax.tree_util.tree_leaves(params)
    assert sum(a.size for a in flat) == sum(t.numel() for t in sd.values())
    x = np.random.default_rng(0).standard_normal((2, 5, H)).astype(np.float32)
    att = params["layer_1"]["attention"]["query"]
    ref = np.einsum("bth,hnd->btnd", x, np.asarray(att["kernel"])) + \
        np.asarray(att["bias"])
    got = pm.layer_1.attention._heads(torch.from_numpy(x),
                                      pm.layer_1.attention.query)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    # the map carries the tree back: the same arrays, reshaped
    np.testing.assert_array_equal(
        sd["layer_0.attention.out.weight"].numpy().T.reshape(
            np.asarray(params["layer_0"]["attention"]["out"]["kernel"])
            .shape),
        np.asarray(params["layer_0"]["attention"]["out"]["kernel"]))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("window,lengths", [
    (512, None),
    (512, [600, 300, 0]),   # truncated to 512, a multiple of 256
    (600, None),
    (600, [600, 250, 1]),
])
def test_logits_match_jax(windows, impl, window, lengths):
    params, toks = windows[window]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = _jax_logits(_jax_model(impl, window), params, toks, jl)
    pm = _port_model(impl, window, params)
    with torch.inference_mode():
        got = pm(torch.from_numpy(toks),
                 None if lengths is None else torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def _flash_module_params(rng):
    """A flax MHDPA-shaped parameter tree (DenseGeneral kernels (H, nh, dh)
    and (nh, dh, H)), drawn with numpy."""
    def arr(*shape):
        return (rng.standard_normal(shape) / np.sqrt(H)).astype(np.float32)

    p = {n: {"kernel": arr(H, 2, 64), "bias": arr(2, 64)}
         for n in ("query", "key", "value")}
    p["out"] = {"kernel": arr(2, 64, H), "bias": arr(H)}
    return p


def test_flash_self_attention_module_matches_jax(rng):
    """The attention module alone, T 70 (JAX pads to 256): rows below each
    length agree; without lengths every row does."""
    x = rng.standard_normal((2, 70, H)).astype(np.float32)
    lengths = np.array([70, 33], np.int32)
    params = _flash_module_params(rng)
    jm = JaxFlashSelfAttention(num_heads=2, hidden_size=H)
    pm = FlashSelfAttention(H, 2, torch.float32,
                            torch.Generator().manual_seed(0))
    sd = bert_state_dict({"attention": params})
    pm.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    for ln in (lengths, None):
        fn = jax.jit(lambda p, x, ln: jm.apply({"params": p}, x, ln))
        with interpret():
            ref = np.asarray(fn(params, jnp.asarray(x),
                                None if ln is None else jnp.asarray(ln)))
        with torch.no_grad():
            got = pm(torch.from_numpy(x),
                     None if ln is None else torch.from_numpy(ln))
        for i in range(2):
            n = 70 if ln is None else int(ln[i])
            np.testing.assert_allclose(got[i, :n].numpy(), ref[i, :n],
                                       atol=ATOL, rtol=0)


# bf16 compute: each dense product, the scores, the softmax and GELU round
# to 8 bits in both frameworks, at other places (XLA fuses, torch does not);
# logits of magnitude ~1 after 2 layers
BF16_ATOL = 5e-2


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_logits_match_jax(windows, impl):
    params, toks = windows[512]
    lengths = [600, 300, 0]
    ref = _jax_logits(_jax_model(impl, 512, jnp.bfloat16), params, toks,
                      jnp.asarray(lengths))
    pm = _port_model(impl, 512, params, torch.bfloat16)
    with torch.inference_mode():
        got = pm(torch.from_numpy(toks), torch.tensor(lengths))
    assert got.dtype == torch.float32  # the classifier runs in f32
    np.testing.assert_allclose(got.numpy(), ref, atol=BF16_ATOL, rtol=0)


@pytest.fixture(scope="module")
def grad_setup():
    """A 256-position model (T a flash block multiple, so a length-0 row
    is compared too), its params, a batch and labels."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, V, (B, 256)).astype(np.int32)
    params = _jax_model("xla", 256).init(
        jax.random.key(1), jnp.asarray(toks), lengths=None,
        deterministic=True)["params"]
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    row_w = np.array([1.0, 1.0, 0.0], np.float32)  # a padded last row
    return params, toks, labels, row_w


@pytest.mark.parametrize("mode", ["train", "eval_flash"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_gradients_match_jax_under_transplant(grad_setup, mode,
                                              with_lengths):
    """Loss and every parameter's gradient of the weighted BCE: ``train``
    is a training step (both take the plain attention route); ``eval_flash``
    differentiates an eval-mode forward with ``transformer_attention=
    "flash"``, JAX through the library kernel's backward (interpret mode),
    the port through ``flash_attention``'s backward."""
    params, toks, labels, row_w = grad_setup
    lens = np.array([256, 100, 0], np.int32)
    impl = "flash" if mode == "eval_flash" else "xla"
    jm = _jax_model(impl, 256)
    loss_fn = make_loss_fn(jm, use_lengths=with_lengths)
    deterministic = mode == "eval_flash"
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                      static_argnums=6)
    with interpret():
        (ref_loss, _), ref_grads = grad_fn(
            params, jnp.asarray(toks), jnp.asarray(lens),
            jnp.asarray(labels), jnp.asarray(row_w), jax.random.key(0),
            deterministic)
    pm = _port_model(impl, 256, params)
    pm.train(mode == "train")
    logits = pm(torch.from_numpy(toks),
                torch.from_numpy(lens) if with_lengths else None)
    loss = weighted_bce(logits, torch.from_numpy(labels),
                        torch.from_numpy(row_w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-6)
    ref = bert_state_dict(jax.device_get(ref_grads))
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_frame_inputs_match_jax(rng):
    """Float frames (the ``use_precomputed_embeddings`` route) go through
    ``frame_proj``; logits equal JAX's."""
    frames = rng.standard_normal((2, 40, 16)).astype(np.float32)
    jm = _jax_model("xla", 64)
    params = jm.init(jax.random.key(2), jnp.asarray(frames), lengths=None,
                     deterministic=True)["params"]
    assert "frame_proj" in params and "tok_embed" not in params
    ref = _jax_logits(jm, params, frames, None)
    pm = TransformerClassifier(V, LAYERS, C, H, 64, 0.0, torch.float32,
                               "xla", frame_dim=16, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(bert_state_dict(jax.device_get(params)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def _cfg(**kw):
    base = dict(model_type="bert", vocab_size=V, num_classes=C,
                hidden_size=H, num_layers=1, compute_dtype="float32",
                transformer_max_position=64)
    base.update(kw)
    return AudioTokensConfig(**base)


def test_route_resolution_and_refusals():
    """JAX's rules: 'auto' -> 'xla', 'flash' and 'xla' pass through, junk
    raises; an unknown compute dtype raises."""
    resolve = registry._resolve_transformer_attention
    assert resolve(_cfg()) == "xla"
    assert resolve(_cfg(transformer_attention="xla")) == "xla"
    assert resolve(_cfg(transformer_attention="flash")) == "flash"
    with pytest.raises(ValueError, match="transformer_attention"):
        resolve(_cfg(transformer_attention="Flash"))
    gen = torch.Generator().manual_seed(0)
    m = get_model(_cfg(transformer_attention="flash"), "cpu", gen)
    assert isinstance(m, TransformerClassifier)
    assert m.attention_impl == "flash" and m.max_position == 64
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model(_cfg(compute_dtype="float16"), "cpu", gen)


def test_flash_only_in_eval_mode(monkeypatch):
    """With 'flash', eval mode runs B5 in every layer; train mode takes the
    plain route (as the JAX model: no attention dropout in the kernel)."""
    calls = []
    real = transformer.flash_attention

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(transformer, "flash_attention", counting)
    m = get_model(_cfg(transformer_attention="flash", num_layers=2,
                       dropout=0.1), "cpu", torch.Generator().manual_seed(0))
    toks = torch.randint(0, V, (2, 64), generator=torch.Generator()
                         .manual_seed(1))
    m.eval()
    with torch.inference_mode():
        m(toks)
    assert calls == [(2, 2, 64, 64)] * 2
    calls.clear()
    m.train()
    m(toks, generator=torch.Generator().manual_seed(2))
    assert calls == []


def test_dropout_needs_a_generator_and_follows_it():
    m = get_model(_cfg(dropout=0.3), "cpu", torch.Generator().manual_seed(0))
    toks = torch.randint(0, V, (2, 64), generator=torch.Generator()
                         .manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        m(toks)
    a = m(toks, generator=torch.Generator().manual_seed(5))
    b = m(toks, generator=torch.Generator().manual_seed(5))
    c = m(toks, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    m.eval()  # no dropout, no generator needed
    torch.testing.assert_close(m(toks), m(toks), atol=0, rtol=0)
