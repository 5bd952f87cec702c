"""On a CUDA card only: each hand-written kernel of the port against its
plain PyTorch version.  Without a card every test here skips.

This file imports neither jax nor the JAX package, so on a machine with a
card and no jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    from audio_tokens_tpu_torch.ops.common import exact_f32

    exact_f32()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
def test_cuda_vq_kernel_matches_plain(cuda_device, normalize):
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1000, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32))
    x, c = x.to(cuda_device), c.to(cuda_device)
    before = vq_argmin.launches
    got = vq_argmin(x, c, normalize)
    assert vq_argmin.launches == before + 1
    ref = vq_argmin_plain(x, c, normalize)
    check_near_ties(l2_normalize(x) if normalize else x, c, got, ref)


@pytest.mark.cuda
def test_cuda_tokenizer_kernel_matches_plain(cuda_device):
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    rng = np.random.default_rng(0)
    cents = rng.standard_normal((300, 32)).astype(np.float32)
    fe = MelFrontend("cpu", 22050, 32, 256, 128, int(22050 * 1.5))
    kern = TokenizerKernel(22050, 32, 256, 128, fe.frames_max, cents,
                           cuda_device)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.4, 0.9, 1.5)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(cuda_device)
    before = TokenizerKernel.launches
    got = kern(x)
    assert TokenizerKernel.launches == before + 1
    check_near_ties(l2_normalize(kern.log_mel_plain(x)), kern.centroids,
                    got, kern.plain(x))


LSTM_SHAPES = [
    (24, 8, 128),   # 4 threads share each dot product
    (50, 1, 512),   # the single-clip request's batch
    (20, 256, 64),  # 1024 (b, u) pairs: one thread each
    (17, 6, 36),    # a ragged batch tile, H not a multiple of the tiles
]


def _lstm_inputs(device, t, b, h):
    gen = torch.Generator().manual_seed(0)
    xg = torch.randn((t, b, 4 * h), generator=gen).to(device)
    w = (torch.rand((h, 4 * h), generator=gen) * 0.2 - 0.1).to(device)
    lens = torch.randint(3, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float().to(device)
    return gen, xg, mask, w


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", LSTM_SHAPES)
def test_cuda_lstm_kernel_matches_plain(cuda_device, reverse, t, b, h):
    """B3, with and without its residual stores."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_fwd,
                                                      lstm_sequence_fwd_plain)

    _, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    ref = lstm_sequence_fwd_plain(xg, mask, w, reverse)
    for residuals in (False, True):
        before = lstm_sequence_fwd.launches
        got = lstm_sequence_fwd(xg, mask, w, reverse, residuals)
        assert lstm_sequence_fwd.launches == before + 1
        for name, g, r in zip(("hs", "gates", "c", "h_last"), got, ref):
            if g is None:
                assert not residuals and name in ("gates", "c")
                continue
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", LSTM_SHAPES)
def test_cuda_lstm_backward_kernel_matches_plain(cuda_device, reverse, t, b,
                                                 h):
    """B4 on the plain forward's residuals: dxg within 1e-5, dw_hh within
    1e-5 of its largest entry (another summation order over T*B rows)."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_sequence_bwd, lstm_sequence_bwd_plain, lstm_sequence_fwd_plain)

    gen, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    hs, gates, c, _ = lstm_sequence_fwd_plain(xg, mask, w, reverse)
    dhs = torch.randn((t, b, h), generator=gen).to(cuda_device)
    dh_last = torch.randn((b, h), generator=gen).to(cuda_device)
    before = lstm_sequence_bwd.launches
    dxg, dw = lstm_sequence_bwd(dhs, dh_last, gates, c, hs, mask, w, reverse)
    assert lstm_sequence_bwd.launches == before + 1
    ref_dxg, ref_dw = lstm_sequence_bwd_plain(dhs, dh_last, gates, c, hs,
                                              mask, w, reverse)
    torch.testing.assert_close(dxg, ref_dxg, atol=1e-5, rtol=1e-5)
    assert float((dw - ref_dw).abs().max()) <= 1e-5 * float(
        ref_dw.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("with_lengths", [False, True])
def test_cuda_classifier_backward_reaches_every_parameter(cuda_device,
                                                          with_lengths):
    """The fault this pins: the CUDA recurrence once returned tensors with
    no autograd history, so loss.backward() filled only the linear head.
    Now every parameter gets the CPU model's gradient (atol 1e-5)."""
    from audio_tokens_tpu_torch.models.lstm import SimpleLSTMTokenClassifier
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    def model(device):
        return SimpleLSTMTokenClassifier(
            50, 16, 64, 2, 7, device=device,
            generator=torch.Generator().manual_seed(0))

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 50, (6, 30), generator=gen)
    lens = torch.randint(5, 31, (6,), generator=gen)
    labels = (torch.rand((6, 7), generator=gen) < 0.3).float()
    row_w = torch.tensor([1.0, 1, 1, 1, 1, 0])
    grads = {}
    for device in ("cpu", cuda_device):
        m = model(device)
        fwd, bwd = lstm_sequence_fwd.launches, lstm_sequence_bwd.launches
        loss = weighted_bce(
            m(toks.to(device), lens.to(device) if with_lengths else None),
            labels.to(device), row_w.to(device))
        loss.backward()
        if device != "cpu":  # 2 layers x 2 directions, each way
            assert lstm_sequence_fwd.launches == fwd + 4
            assert lstm_sequence_bwd.launches == bwd + 4
        grads[str(device)] = {n: p.grad for n, p in m.named_parameters()}
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    assert sorted(card) == sorted(cpu)
    for name in cpu:
        assert card[name] is not None, f"{name} got no gradient on the card"
        torch.testing.assert_close(card[name].cpu(), cpu[name], atol=1e-5,
                                   rtol=1e-4, msg=name)


FLASH_SHAPES = [
    (2, 2, 100),   # one partial tile
    (1, 3, 257),   # T one past a tile multiple
    (3, 1, 64),    # exactly one tile
]
# bf16: P and the output each rounded to 8 bits (2^-8 relative), the
# kernel rounding P against its running row max, the plain version against
# the final one; outputs of magnitude below 4
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _flash_inputs(device, b, nh, t, dtype):
    gen = torch.Generator().manual_seed(t)
    q, k, v, do = (torch.randn((b, nh, t, 64), generator=gen).to(device,
                                                                  dtype)
                   for _ in range(4))
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[-1] = 0  # a row with no valid key: every query in segment 1
    seg = (torch.arange(t)[None, :] >= lens[:, None]).to(torch.int32)
    return q, k, v, do, seg.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,t", FLASH_SHAPES)
def test_cuda_flash_forward_matches_plain(cuda_device, dtype, b, nh, t):
    """B5 forward, with and without the logsumexp store, on every row."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_fwd, flash_attention_plain)

    q, k, v, _, seg = _flash_inputs(cuda_device, b, nh, t, dtype)
    ref_o, ref_lse = flash_attention_plain(q, k, v, seg, 0.125, True)
    for lse in (False, True):
        before = flash_attention_fwd.launches
        o, got_lse = flash_attention_fwd(q, k, v, seg, 0.125, lse)
        assert flash_attention_fwd.launches == before + 1
        torch.testing.assert_close(o.float(), ref_o.float(),
                                   **FLASH_TOL[dtype])
        if lse:
            torch.testing.assert_close(got_lse, ref_lse, atol=1e-5,
                                       rtol=1e-5)
        else:
            assert got_lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,t", FLASH_SHAPES)
def test_cuda_flash_backward_matches_plain(cuda_device, dtype, b, nh, t):
    """The dk/dv and dq kernels on the plain forward's logsumexp: each
    gradient within 1e-5 (f32) or 2e-2 (bf16: P and dS rounded to 8 bits)
    of its largest entry."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_plain, flash_attention_dq_plain,
        flash_attention_plain)

    q, k, v, do, seg = _flash_inputs(cuda_device, b, nh, t, dtype)
    o, lse = flash_attention_plain(q, k, v, seg, 0.125, True)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, seg, lse, do, di, 0.125)
    launches = (flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches)
    got = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    ref = (*flash_attention_dkv_plain(*args), flash_attention_dq_plain(*args))
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for name, g, r in zip(("dk", "dv", "dq"), got, ref):
        assert g.dtype == dtype
        err = float((g.float() - r.float()).abs().max())
        assert err <= rel * float(r.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_cuda_flash_autograd_runs_the_three_kernels(cuda_device):
    """FlashAttention on the card: one forward, one dk/dv and one dq
    launch, gradients equal to autograd through the plain forward."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd, flash_attention_plain)

    q, k, v, do, seg = _flash_inputs(cuda_device, 2, 2, 130, torch.float32)
    counters = (flash_attention_fwd, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, seg, 0.125)
    got = torch.autograd.grad(o, leaves, do)
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        flash_attention_plain(*ref_leaves, seg, 0.125), ref_leaves, do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_bert_eval_matches_cpu(cuda_device):
    """The bert classifier in eval mode (the B5 route) on the card vs the
    CPU (plain attention version), f32, lengths with a 0 (atol 1e-4)."""
    from audio_tokens_tpu_torch.models.transformer import (
        TransformerClassifier)
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd

    def model(device):
        m = TransformerClassifier(50, 2, 7, 128, 200, 0.0, torch.float32,
                                  "flash", device=device,
                                  generator=torch.Generator().manual_seed(0))
        return m.eval()

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 50, (4, 150), generator=gen)
    lens = torch.tensor([150, 77, 1, 0])
    out = {}
    for device in ("cpu", cuda_device):
        before = flash_attention_fwd.launches
        with torch.inference_mode():
            out[str(device)] = model(device)(toks.to(device),
                                             lens.to(device)).cpu()
        if device != "cpu":
            assert flash_attention_fwd.launches == before + 2  # 2 layers
    torch.testing.assert_close(out[str(cuda_device)], out["cpu"], atol=1e-4,
                               rtol=1e-4)
