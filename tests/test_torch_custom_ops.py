"""The serving kernels as ``torch.library`` custom ops (``atk::vq_argmin``,
``atk::tokenize``, ``atk::lstm_fwd``, ``atk::flash_fwd``) on the CPU:
``torch.library.opcheck`` on each (schema, fake, autograd registration,
AOT dispatch with dynamic shapes), each wrapper's output equal to its plain
version bit for bit (the op's CPU registration is that version), the fakes
allocating outputs without loading a kernel library or counting a launch,
and the lstm's scan form equal to its loop.  The ``cuda`` tests run the
same on a card, where the count moves inside the op's CUDA registration.

This file imports neither jax nor the JAX package.
"""

import numpy as np
import pytest
import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.cuda_attention import (
    flash_attention_fwd, flash_attention_plain)
from audio_tokens_tpu_torch.ops.cuda_lstm import (
    lstm_sequence_fwd, lstm_sequence_fwd_plain, lstm_sequence_scan)
from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
from audio_tokens_tpu_torch.ops.mel import MelFrontend

SR, N_MELS, N_FFT, HOP = 22050, 32, 256, 128


def _vq_args(device, normalize, seed=0):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.standard_normal((300, 24)).astype(
        np.float32)).to(device)
    cents = torch.from_numpy(rng.standard_normal((40, 24)).astype(
        np.float32)).to(device)
    return frames, cents, normalize


def _tokenizer(device, seed=1):
    """A small B1 (32 mel bins, n_fft 256, hop 128, 1.5 s clips, K 40) and
    a padded batch of 3 clips."""
    rng = np.random.default_rng(seed)
    fe = MelFrontend("cpu", SR, N_MELS, N_FFT, HOP, int(SR * 1.5))
    cents = rng.standard_normal((40, N_MELS)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    kern = TokenizerKernel(SR, N_MELS, N_FFT, HOP, fe.frames_max, cents,
                           device)
    clips = [(0.3 * rng.standard_normal(int(SR * s))).astype(np.float32)
             for s in (1.5, 1.0, 0.7)]
    return kern, torch.from_numpy(fe.prepare_batch(clips)[0]).to(device)


def _tokenize_args(kern, padded):
    return (padded, kern._kbasis, kern._kfbank, kern.centroids, kern.c2,
            kern.n_fft, kern.hop, kern.padded_len, kern.n_frames)


def _lstm_args(device, t=9, b=3, h=8, seed=2):
    """xg, a ragged prefix mask (one row of length 0) and w_hh."""
    gen = torch.Generator().manual_seed(seed)
    xg = torch.randn((t, b, 4 * h), generator=gen)
    w_hh = (torch.rand((h, 4 * h), generator=gen) * 2 - 1) / h ** 0.5
    lens = torch.tensor([t, t // 2, 0][:b])
    mask = (torch.arange(t)[:, None] < lens[None, :]).float()
    return xg.to(device), mask.to(device), w_hh.to(device)


def _flash_args(device, dtype, b=2, nh=2, t=11, dh=64, seed=3):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, nh, t, dh), generator=gen).to(dtype)
               for _ in range(3))
    seg = (torch.arange(t)[None, :] >= torch.tensor([[t], [5]])).to(
        torch.int32)
    return [x.to(device) for x in (q, k, v, seg)]


@pytest.mark.parametrize("normalize", [False, True])
def test_vq_argmin_op_passes_opcheck_and_equals_plain(normalize):
    args = _vq_args("cpu", normalize)
    torch.library.opcheck(torch.ops.atk.vq_argmin.default, args)
    got = vq_argmin(*args)
    assert got.dtype == torch.int32
    assert torch.equal(got, vq_argmin_plain(*args))


def test_tokenize_op_passes_opcheck_and_equals_plain():
    kern, padded = _tokenizer("cpu")
    torch.library.opcheck(torch.ops.atk.tokenize.default,
                          _tokenize_args(kern, padded))
    got = kern(padded)
    assert got.shape == (3, kern.n_frames) and got.dtype == torch.int32
    assert torch.equal(got, kern.plain(padded))
    # the int16 wire is decoded before the op
    pcm = torch.clamp(torch.round(padded * 32768), -32768, 32767).to(
        torch.int16)
    assert torch.equal(kern(pcm), kern.plain(pcm))


@pytest.mark.parametrize("reverse,residuals", [(False, False), (True, True)])
def test_lstm_fwd_op_passes_opcheck_and_equals_plain(reverse, residuals):
    xg, mask, w_hh = _lstm_args("cpu")
    torch.library.opcheck(torch.ops.atk.lstm_fwd.default,
                          (xg, mask, w_hh, reverse, residuals))
    got = lstm_sequence_fwd(xg, mask, w_hh, reverse, residuals)
    ref = lstm_sequence_fwd_plain(xg, mask, w_hh, reverse)
    for g, r in zip(got, ref):
        if not residuals and g is None:
            continue
        assert torch.equal(g, r)
    assert (got[1] is None) == (not residuals)


@pytest.mark.parametrize("dtype,lse", [(torch.float32, True),
                                       (torch.bfloat16, False)])
def test_flash_fwd_op_passes_opcheck_and_equals_plain(dtype, lse):
    q, k, v, seg = _flash_args("cpu", dtype)
    torch.library.opcheck(torch.ops.atk.flash_fwd.default,
                          (q, k, v, seg, 0.125, lse))
    o, row_lse = flash_attention_fwd(q, k, v, seg, 0.125, lse)
    ref = flash_attention_plain(q, k, v, seg, 0.125, True)
    assert o.dtype == dtype and torch.equal(o, ref[0])
    if lse:
        assert torch.equal(row_lse, ref[1])
    else:
        assert row_lse is None


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_lstm_equals_the_loop(reverse):
    """The scan form of the plain recurrence (what a portable serving
    export traces) against the Python loop, a ragged mask with a row of
    length 0: the same step, so the same bits."""
    xg, mask, w_hh = _lstm_args("cpu", t=23, b=3, h=12, seed=4)
    hs, h_last = lstm_sequence_scan(xg, mask, w_hh, reverse)
    ref = lstm_sequence_fwd_plain(xg, mask, w_hh, reverse)
    torch.testing.assert_close(hs, ref[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(h_last, ref[3], rtol=0, atol=1e-6)


def test_fakes_allocate_only():
    """On meta tensors each op runs its fake: the outputs' shapes and
    dtypes (B5's logsumexp in f32 for bf16 q, empty residual planes), no
    kernel library loaded, no launch counted."""
    loaded = dict(_build._loaded)
    counters = (vq_argmin, TokenizerKernel, lstm_sequence_fwd,
                flash_attention_fwd)
    before = [c.launches for c in counters]
    meta = torch.device("meta")
    ids = torch.ops.atk.vq_argmin(*_vq_args(meta, True))
    assert ids.shape == (300,) and ids.dtype == torch.int32
    kern, padded = _tokenizer(meta)
    tokens = kern(padded)
    assert tokens.shape == (3, kern.n_frames) and tokens.dtype == torch.int32
    xg, mask, w_hh = _lstm_args(meta)
    hs, h_last, gates, c = torch.ops.atk.lstm_fwd(xg, mask, w_hh, True, False)
    assert (hs.shape, h_last.shape, gates.numel(), c.numel()) == (
        (9, 3, 8), (3, 8), 0, 0)
    _, h_last, gates, c = torch.ops.atk.lstm_fwd(xg, mask, w_hh, False, True)
    assert (gates.shape, c.shape) == ((9, 3, 32), (9, 3, 8))
    q, k, v, seg = _flash_args(meta, torch.bfloat16)
    o, lse = torch.ops.atk.flash_fwd(q, k, v, seg, 0.125, True)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 11)
    assert _build._loaded == loaded
    assert [c.launches for c in counters] == before


def test_cpu_calls_count_no_launch():
    """The plain versions behind the CPU registrations are not launches."""
    counters = (vq_argmin, TokenizerKernel, lstm_sequence_fwd,
                flash_attention_fwd)
    before = [c.launches for c in counters]
    vq_argmin(*_vq_args("cpu", True))
    kern, padded = _tokenizer("cpu")
    kern(padded)
    lstm_sequence_fwd(*_lstm_args("cpu"))
    flash_attention_fwd(*_flash_args("cpu", torch.float32), 0.125)
    assert [c.launches for c in counters] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    from audio_tokens_tpu_torch.ops.common import exact_f32

    exact_f32()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_ops_pass_opcheck(cuda_device):
    torch.library.opcheck(torch.ops.atk.vq_argmin.default,
                          _vq_args(cuda_device, True))
    kern, padded = _tokenizer(cuda_device)
    torch.library.opcheck(torch.ops.atk.tokenize.default,
                          _tokenize_args(kern, padded))
    torch.library.opcheck(torch.ops.atk.lstm_fwd.default,
                          (*_lstm_args(cuda_device), True, True))
    torch.library.opcheck(torch.ops.atk.flash_fwd.default,
                          (*_flash_args(cuda_device, torch.bfloat16), 0.125,
                           True))


@pytest.mark.cuda
def test_cuda_registrations_count_each_launch(cuda_device):
    """Calling an op itself, not its wrapper, moves the wrapper's count:
    the count sits in the CUDA registration, which a loaded exported
    program reaches."""
    counters = (vq_argmin, TokenizerKernel, lstm_sequence_fwd,
                flash_attention_fwd)
    before = [c.launches for c in counters]
    torch.ops.atk.vq_argmin(*_vq_args(cuda_device, True))
    kern, padded = _tokenizer(cuda_device)
    torch.ops.atk.tokenize(*_tokenize_args(kern, padded))
    torch.ops.atk.lstm_fwd(*_lstm_args(cuda_device), False, False)
    torch.ops.atk.flash_fwd(*_flash_args(cuda_device, torch.float32), 0.125,
                            False)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
