"""The simple, cnn and baseline classifiers of the port against the JAX
modules under a ``convert.py`` transplant, and their training through the
port's Trainer against the JAX Trainer.

Weights are random normals from a seeded numpy RNG (biases too, so that a
transposed or permuted map shows), inputs as well.  Tolerances: float32
logits rtol 1e-5 / atol 1e-6; float32 gradients (``jax.value_and_grad`` of
the JAX weighted BCE, carried over by the same map) within 1e-5 of each
tensor's largest entry, elementwise rtol 1e-5; bf16 logits within
``BF16_TOL`` of the largest logit.  Trainer losses within 5e-5, as
``tests/test_torch_train.py`` holds the lstm."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.datasets import DataLoaderCreator
from audio_tokens_tpu.models.cnn import CNNClassifier as JaxCNN
from audio_tokens_tpu.models.mlp import BaselineMLPClassifier as JaxMLP
from audio_tokens_tpu.models.simple import SimpleTokenClassifier as JaxSimple
from audio_tokens_tpu.train import trainer as jax_trainer
from audio_tokens_tpu.train.objective import make_loss_fn
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import state_dict_for
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.models.cnn import CNNClassifier
from audio_tokens_tpu_torch.models.mlp import BaselineMLPClassifier
from audio_tokens_tpu_torch.models.simple import SimpleTokenClassifier
from audio_tokens_tpu_torch.train import trainer as port_trainer
from audio_tokens_tpu_torch.train.objective import weighted_bce
from tests import token_corpus

B, C, E = 4, 7, 16
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-5
# bf16: both sides round each layer's product and bias sum to 8 bits; a
# different summation order may put one value on the neighbouring bf16
# number (2**-8 relative), which the next layers carry on
BF16_TOL = 2e-2
LOSS_ATOL = 5e-5
MAP_ATOL = 1e-3
# even and odd sizes: pooling floors odd T and n_mels (VALID)
CNN_SIZES = [(16, 8), (13, 9), (15, 12)]


def randomize(params, rng):
    """Every leaf replaced by seeded normals: kernels and embeddings of
    std 1/sqrt(fan_in), biases of std 0.1."""
    def leaf(p):
        p = np.asarray(p)
        std = 1.0 / np.sqrt(np.prod(p.shape[:-1])) if p.ndim >= 2 else 0.1
        return (rng.standard_normal(p.shape) * std).astype(np.float32)

    return jax.tree.map(leaf, jax.device_get(params))


def _simple(rng, vocab, seq):
    jm = JaxSimple(vocab_size=vocab, hidden_size=E, num_classes=C)
    x = rng.integers(0, vocab, (B, seq)).astype(np.int32)
    params = randomize(jm.init(jax.random.key(0), jnp.asarray(x))["params"],
                       rng)
    pm = SimpleTokenClassifier(vocab, E, C, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return jm, pm, params, x


def _cnn(rng, t, m, jdt=jnp.float32, tdt=torch.float32):
    jm = JaxCNN(num_classes=C, compute_dtype=jdt)
    x = rng.standard_normal((B, t, m)).astype(np.float32)
    params = randomize(jm.init(jax.random.key(0), jnp.asarray(x))["params"],
                       rng)
    pm = CNNClassifier(t, m, C, tdt, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return jm, pm, params, x


def _mlp(rng, jdt=jnp.float32, tdt=torch.float32, t=13, m=9):
    jm = JaxMLP(num_classes=C, compute_dtype=jdt)
    x = rng.standard_normal((B, t * m)).astype(np.float32)
    params = randomize(jm.init(jax.random.key(0), jnp.asarray(x))["params"],
                       rng)
    pm = BaselineMLPClassifier(t * m, C, tdt, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return jm, pm, params, x


def _logits_pair(jm, pm, params, model_type, x, lengths=None):
    pm.load_state_dict(state_dict_for(model_type, params))
    ref = jm.apply({"params": params}, jnp.asarray(x),
                   lengths=None if lengths is None else jnp.asarray(lengths))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x),
                 None if lengths is None else torch.from_numpy(lengths))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("vocab", [48, 4096])  # count GEMM, gather route
@pytest.mark.parametrize("with_lengths", [False, True])
def test_simple_matches_jax_under_transplant(rng, vocab, with_lengths):
    jm, pm, params, x = _simple(rng, vocab, 20)
    lens = np.array([5, 20, 0, 27], np.int32) if with_lengths else None
    got, ref = _logits_pair(jm, pm, params, "simple", x, lens)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_simple_without_lengths_averages_the_padding(rng):
    """Reference semantics: with ``lengths=None`` pad token 0 counts."""
    _, pm, params, x = _simple(rng, 48, 20)
    pm.load_state_dict(state_dict_for("simple", params))
    x[:, 10:] = 0
    full = pm(torch.from_numpy(x))
    masked = pm(torch.from_numpy(x), torch.full((B,), 10))
    trimmed = pm(torch.from_numpy(x[:, :10]))
    torch.testing.assert_close(masked, trimmed, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(full, masked)


@pytest.mark.parametrize("t,m", CNN_SIZES)
def test_cnn_matches_jax_under_transplant(rng, t, m):
    jm, pm, params, x = _cnn(rng, t, m)
    got, ref = _logits_pair(jm, pm, params, "cnn", x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_cnn_transplant_sees_the_flatten_order(rng):
    """fc1's rows follow flax's NHWC flatten, (t, m, channel) with the
    channel fastest.  The same rows in NCHW order (channel slowest), as a
    map for a channel-major flatten would lay them, give other logits: the
    transplant tests above would catch that flatten."""
    jm, pm, params, x = _cnn(rng, 16, 8)
    got, ref = _logits_pair(jm, pm, params, "cnn", x)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    sd = state_dict_for("cnn", params)
    sd["fc1.weight"] = (sd["fc1.weight"].reshape(256, 4, 2, 64)
                        .permute(0, 3, 1, 2).reshape(256, -1))
    pm.load_state_dict(sd)
    with torch.inference_mode():
        wrong = pm(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - ref).max() > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("t,m", CNN_SIZES[:2])
def test_cnn_bf16_matches_jax_under_transplant(rng, t, m):
    jm, pm, params, x = _cnn(rng, t, m, jnp.bfloat16, torch.bfloat16)
    got, ref = _logits_pair(jm, pm, params, "cnn", x)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


def test_baseline_matches_jax_under_transplant(rng):
    jm, pm, params, x = _mlp(rng)
    got, ref = _logits_pair(jm, pm, params, "baseline", x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_baseline_bf16_matches_jax_under_transplant(rng):
    jm, pm, params, x = _mlp(rng, jnp.bfloat16, torch.bfloat16)
    got, ref = _logits_pair(jm, pm, params, "baseline", x)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


def test_bf16_rounds_where_flax_rounds(rng):
    """The bf16 models compute in bf16 (not f32 with a cast at the end):
    their logits differ from the f32 models' on the same weights."""
    _, p32, params, x = _mlp(rng)
    p16 = BaselineMLPClassifier(13 * 9, C, torch.bfloat16, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    for pm in (p32, p16):
        pm.load_state_dict(state_dict_for("baseline", params))
    a, b = p32(torch.from_numpy(x)), p16(torch.from_numpy(x))
    assert b.dtype == torch.float32 and not torch.equal(a, b)
    assert p16.fc1.weight.dtype == torch.float32  # parameters stay f32


GRAD_CASES = {
    "simple-v48": lambda rng: ("simple", *_simple(rng, 48, 20)),
    "simple-v4096": lambda rng: ("simple", *_simple(rng, 4096, 20)),
    "cnn-even": lambda rng: ("cnn", *_cnn(rng, 16, 8)),
    "cnn-odd": lambda rng: ("cnn", *_cnn(rng, 13, 9)),
    "baseline": lambda rng: ("baseline", *_mlp(rng)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_match_jax_under_transplant(rng, case):
    """Loss and every parameter's gradient of the weighted BCE (one padded
    row of weight 0), the port's autograd vs ``jax.value_and_grad``; the
    simple family with lengths."""
    model_type, jm, pm, params, x = GRAD_CASES[case](rng)
    pm.load_state_dict(state_dict_for(model_type, params))
    lens = rng.integers(1, x.shape[1] + 1, (B,)).astype(np.int32)
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    row_w = np.ones(B, np.float32)
    row_w[-1] = 0.0
    use_lengths = model_type == "simple"
    loss_fn = make_loss_fn(jm, use_lengths=use_lengths)
    (ref_loss, _), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(labels),
        jnp.asarray(row_w), None, True)
    logits = pm(torch.from_numpy(x),
                torch.from_numpy(lens) if use_lengths else None)
    loss = weighted_bce(logits, torch.from_numpy(labels),
                        torch.from_numpy(row_w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-6)
    ref = state_dict_for(model_type, ref_grads)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("model_type,input_shape", [
    ("simple", (2, 64)), ("cnn", (2, 64, 32)), ("baseline", (2, 64 * 32))])
def test_get_model_builds_each_family_from_config(model_type, input_shape):
    """The same config fields as the JAX registry: hidden_size for simple,
    num_classes and compute_dtype (default bf16) for cnn and baseline,
    sized by max_seq_len x n_mels."""
    cfg = AudioTokensConfig(model_type=model_type, num_classes=C,
                            vocab_size=16, hidden_size=E, max_seq_len=64,
                            n_mels=32)
    model = get_model(cfg, "cpu", torch.Generator().manual_seed(0))
    if model_type == "simple":
        x = torch.zeros(input_shape, dtype=torch.int32)
        assert tuple(model.embedding.weight.shape) == (16, E)
    else:
        x = torch.zeros(input_shape)
        assert model.compute_dtype == torch.bfloat16
    assert tuple(model(x).shape) == (2, C)
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model(AudioTokensConfig(model_type="cnn", compute_dtype="fp16"),
                  "cpu", torch.Generator())


def test_state_dict_maps_refuse_a_foreign_tree(rng):
    _, _, params, _ = _mlp(rng)
    with pytest.raises(KeyError, match="fc3"):
        state_dict_for("cnn", params)
    with pytest.raises(ValueError, match="Unknown model type"):
        state_dict_for("gru", params)


# -- the Trainer on each family ---------------------------------------------

def make_spec_corpus(base: Path, seed: int = 4) -> None:
    """``token_corpus``'s metadata, split and tokens, plus a (n_mels, n)
    float32 spectrogram per clip under ``spectrograms/{split}`` (the layout
    SpectrogramGenerator writes), lengths straddling ``max_seq_len``."""
    token_corpus.make_token_corpus(base)
    cfg = token_corpus.config(base)
    split = json.loads(Path(cfg.split_file).read_text())
    gen = np.random.default_rng(seed)
    for name, ytids in split.items():
        out = Path(cfg.source_spec_path) / name
        out.mkdir(parents=True, exist_ok=True)
        for ytid in ytids:
            n = int(gen.integers(cfg.max_seq_len // 3, 2 * cfg.max_seq_len))
            np.save(out / f"{ytid}.npy", gen.standard_normal(
                (cfg.n_mels, n)).astype(np.float32))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("spec_corpus")
    make_spec_corpus(base)
    return base


def _record_losses(monkeypatch, module):
    seen = []
    add = module._LossMean.add

    def recording_add(self, loss):
        seen.append(float(np.asarray(loss)))
        add(self, loss)

    monkeypatch.setattr(module._LossMean, "add", recording_add)
    return seen


@pytest.mark.parametrize("family", [
    dict(model_type="simple", hidden_size=E, reference_compat=False),
    # the corpus' lr 3e-3 moves each of fc1's 8,192 (cnn) and 2,048
    # (baseline) weights a row by 3e-3 in AdamW's first step: the loss
    # jumps to ~10, where f32 rounding alone reaches 5e-5; at 3e-4 it
    # stays below 1.5
    dict(model_type="cnn", dataset_type="RawSTFTDataset",
         learning_rate=3e-4),
    dict(model_type="baseline", dataset_type="RawSTFTFlatDataset",
         learning_rate=3e-4),
], ids=["simple", "cnn", "baseline"])
def test_trainer_matches_jax_trainer(corpus, tmp_path, monkeypatch, family):
    """One epoch at compute_dtype float32 from the JAX Trainer's own init:
    5 train steps (the last on 2 real rows) and 2 validation batches."""
    kw = dict(family, epochs=1, compute_dtype="float32",
              checkpoint_dir=str(tmp_path / "ckpt"))
    jcfg = token_corpus.config(corpus, **kw)
    jt = jax_trainer.Trainer(jcfg)
    train_loader, _ = DataLoaderCreator(jcfg).get_dataloaders()
    params, _ = jt._init_state(train_loader)
    pt = port_trainer.Trainer(token_corpus.port_config(corpus, **kw), "cpu")
    pt.model.load_state_dict(state_dict_for(jcfg.model_type,
                                            jax.device_get(params)))

    jax_losses = _record_losses(monkeypatch, jax_trainer)
    j_loss, j_metrics = jt.run()
    port_losses = _record_losses(monkeypatch, port_trainer)
    p_loss, p_metrics = pt.run()

    assert len(port_losses) == len(jax_losses) == 7
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL,
                               rtol=0)
    assert abs(p_loss - j_loss) <= LOSS_ATOL
    assert abs(p_metrics["mAP"] - j_metrics["mAP"]) <= MAP_ATOL
    assert port_losses[4] != port_losses[0]  # the weights moved
