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


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", [
    (24, 8, 128),   # 4 threads share each dot product
    (50, 1, 512),   # the single-clip request's batch
    (20, 256, 64),  # 1024 (b, u) pairs: one thread each
])
def test_cuda_lstm_kernel_matches_plain(cuda_device, reverse, t, b, h):
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence,
                                                      lstm_sequence_plain)

    gen = torch.Generator().manual_seed(0)
    xg = torch.randn((t, b, 4 * h), generator=gen).to(cuda_device)
    w = (torch.rand((h, 4 * h), generator=gen) * 0.2 - 0.1).to(cuda_device)
    lens = torch.randint(3, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float().to(cuda_device)
    before = lstm_sequence.launches
    hs, h_last = lstm_sequence(xg, mask, w, reverse)
    assert lstm_sequence.launches == before + 1
    hs_ref, h_ref = lstm_sequence_plain(xg, mask, w, reverse)
    torch.testing.assert_close(hs, hs_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h_last, h_ref, atol=1e-5, rtol=1e-5)
