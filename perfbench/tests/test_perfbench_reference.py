"""The plain reference against PyTorch's own modules at tiny sizes on the
CPU, and the seeded weights against the program's ``state_dict``."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import inputs
from perfbench.reference import adamw, bert, frontend, kmeans, lstm
from perfbench.tests import tiny

CPU = torch.device("cpu")


def test_lstm_loop_matches_nn_lstm():
    torch.manual_seed(0)
    v, e, h, c, b, t = 11, 6, 5, 4, 3, 9
    net = torch.nn.LSTM(e, h, batch_first=True, bidirectional=True).double()
    emb = torch.randn(v, e, dtype=torch.float64)
    fc = torch.nn.Linear(2 * h, c).double()
    w = {"embedding.weight": emb, "fc.weight": fc.weight.detach(),
         "fc.bias": fc.bias.detach()}
    for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
        p = dict(net.named_parameters())
        w[f"lstm_l0_{d}.w_ih"] = p["weight_ih_l0" + sfx].detach().t()
        w[f"lstm_l0_{d}.w_hh"] = p["weight_hh_l0" + sfx].detach().t()
        w[f"lstm_l0_{d}.bias"] = (p["bias_ih_l0" + sfx]
                                  + p["bias_hh_l0" + sfx]).detach()
    tokens = torch.randint(0, v, (b, t))
    _, (hn, _) = net(emb[tokens])
    want = fc(torch.relu(torch.cat([hn[0], hn[1]], dim=-1)))
    got = lstm.logits(tokens, w, 1, "float64")
    torch.testing.assert_close(got, want.detach(), rtol=1e-12, atol=1e-12)


def test_bert_attention_matches_sdpa():
    torch.manual_seed(1)
    cfg = dict(tiny.CONFIGS["bert"], model_type="bert", num_classes=7)
    w = {k: v.double() for k, v in inputs.make_weights(cfg, 3, CPU).items()}
    tokens = torch.randint(0, cfg["vocab_size"], (3, 40))
    got = bert.logits(tokens, w, 1, 40, "float64", block=2)

    def dense(x, name):
        return F.linear(x, w[name + ".weight"], w[name + ".bias"])

    def ln(x, name):
        return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                            w[name + ".bias"], 1e-12)

    h = ln(w["tok_embed.weight"][tokens] + w["pos_embed.weight"][:40],
           "embed_ln")
    q, k, vv = (dense(h, f"layer_0.attention.{n}").view(3, 40, 2, 64)
                .transpose(1, 2) for n in ("query", "key", "value"))
    o = F.scaled_dot_product_attention(q, k, vv).transpose(1, 2).reshape(
        3, 40, 128)
    x = ln(h + dense(o, "layer_0.attention.out"), "layer_0.attn_ln")
    h = ln(x + dense(F.gelu(dense(x, "layer_0.mlp_in")), "layer_0.mlp_out"),
           "layer_0.mlp_ln")
    torch.testing.assert_close(got, dense(h[:, 0], "classifier"),
                               rtol=1e-10, atol=1e-10)


def test_frontend_matches_stft():
    cfg = dict(common_sr=22050, clip_seconds=0.25, n_fft=512, hop_length=128,
               n_mels=64)
    fe = frontend.Frontend(cfg, CPU)
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.standard_normal((2, fe.samples)))
    rows = F.pad(clip[:, None], (256, 256), mode="reflect")[:, 0]
    spec = torch.stft(clip, 512, 128, window=torch.hann_window(
        512, dtype=torch.float64), center=True, pad_mode="reflect",
        return_complex=True).abs() ** 2  # (B, bins, frames)
    mel = spec.transpose(1, 2) @ fe.fbank
    want = 10 * torch.log10(torch.clamp(mel, min=1e-10))
    torch.testing.assert_close(fe.log_mel(rows, "float64"), want,
                               rtol=1e-9, atol=1e-9)
    fb = fe.fbank
    assert fb.shape == (257, 64) and float(fb[-1].abs().max()) == 0.0
    assert float(fb.max()) <= 1.0 and (fb.sum(0) > 0).all()


def test_token_gap_and_nearest():
    feats = torch.tensor([[1.0, 0.0], [0.0, 1.0]], dtype=torch.float64)
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.6, 0.8]])
    best = frontend.nearest(feats, cents, "float64")
    assert best.tolist() == [0, 1]
    assert frontend.token_gap(feats, cents, best) == 0.0
    # token 2 for frame 0: its score 1 - 1.2 = -0.2 against -1
    assert frontend.token_gap(feats, cents, torch.tensor([2, 1])) == (
        pytest.approx(0.8))


def test_adamw_matches_torch():
    torch.manual_seed(2)
    p = {"a": torch.randn(5, 3, dtype=torch.float64),
         "b": torch.randn(4, dtype=torch.float64)}
    leaves = [torch.nn.Parameter(v.clone()) for v in p.values()]
    opt = torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    state: dict = {}
    for t in range(1, 4):
        grads = {k: torch.randn_like(v) for k, v in p.items()}
        for leaf, g in zip(leaves, grads.values()):
            leaf.grad = g.clone()
        opt.step()
        p = adamw.step(p, grads, state, t, 1e-3)
        for leaf, v in zip(leaves, p.values()):
            torch.testing.assert_close(leaf.detach(), v, rtol=1e-13,
                                       atol=1e-15)


def test_lloyd_matches_a_loop():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 4))
    c = x[:5].copy()
    want_obj = 0.0
    for _ in range(4):
        d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        ids = d.argmin(1)
        want_obj = float(d[np.arange(300), ids].sum())
        c = np.stack([x[ids == j].mean(0) if (ids == j).any() else c[j]
                      for j in range(5)])
    got = torch.from_numpy(x[:5])
    for _ in range(4):
        got, obj, _ = kmeans.step(torch.from_numpy(x), got, block=64)
    np.testing.assert_allclose(got.numpy(), c, rtol=1e-12, atol=1e-12)
    assert obj == pytest.approx(want_obj, rel=1e-12)


def test_step_allows_a_tied_row_either_cluster():
    """A row equidistant from two centroids may join either: the other
    choice's centroids lie within the allowance; a row that is not tied
    moved to its second cluster does not."""
    x = torch.tensor([[0.0, 0.0], [-1.0, 0.1], [-1.2, -0.1], [1.0, 0.1],
                      [1.2, -0.1], [-0.5, 5.0]], dtype=torch.float64)
    c = torch.tensor([[-1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    new, obj, allowance = kmeans.step(x, c)
    assert obj == pytest.approx(float(((x - c[[0, 0, 0, 1, 1, 0]]) ** 2)
                                      .sum()))
    assert (allowance > 0).all()
    # the tied row 0 taken by cluster 1 instead of cluster 0
    other = torch.stack([x[[1, 2, 5]].mean(0), x[[0, 3, 4]].mean(0)])
    gap = torch.linalg.vector_norm(other - new, dim=1)
    assert (gap <= allowance * (1 + 1e-12)).all()  # the bound is tight
    # row 1, not tied, taken by cluster 1
    wrong = torch.stack([x[[0, 2, 5]].mean(0), x[[1, 3, 4]].mean(0)])
    gap = torch.linalg.vector_norm(wrong - new, dim=1)
    assert (gap > allowance).any()


@pytest.mark.parametrize("model_type", ["lstm", "bert"])
def test_weights_load_into_the_program(model_type):
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model

    cfg = dict(tiny.CONFIGS[model_type], model_type=model_type, num_layers=2,
               transformer_attention="xla", dropout=0.0)
    w = inputs.make_weights(cfg, 2**33 + 1, CPU)
    acfg = AudioTokensConfig(**cfg)
    model = get_model(acfg, CPU, torch.Generator().manual_seed(0))
    model.load_state_dict(w, strict=True)
    again = inputs.make_weights(cfg, 2**33 + 1, CPU)
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert math.isclose(float(w[next(iter(w))].std()), float(
        again[next(iter(w))].std()))
