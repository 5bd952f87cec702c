"""The port's torch-CPU mirror of the reference pipeline
(``audio_tokens_tpu_torch/tools/torch_mirror.py``) against the JAX
package's (``audio_tokens_tpu/tools/torch_mirror.py``), and
``bench_tokenizer_tiers --torch-mirror`` on the CPU.  Both mirrors set
torch's thread count to the reference's 16; every test here restores the
count it found."""

import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops import mel as jax_mel
from audio_tokens_tpu.tools import torch_mirror as jax_mirror
from audio_tokens_tpu_torch.ops import mel
from audio_tokens_tpu_torch.tools import bench_tokenizer_tiers, torch_mirror

SR, N_MELS, N_FFT, HOP = 22050, 64, 512, 128


@pytest.fixture(autouse=True)
def threads():
    """Restore torch's thread count after each test."""
    n = torch.get_num_threads()
    yield n
    torch.set_num_threads(n)


def _centroids(rng, k: int) -> np.ndarray:
    c = rng.standard_normal((k, N_MELS)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


@pytest.mark.parametrize("n_fft,n_mels", [(N_FFT, N_MELS), (400, 40)])
def test_window_and_filterbank_are_the_jax_modules(n_fft, n_mels):
    np.testing.assert_array_equal(mel.hann_window(n_fft),
                                  jax_mel.hann_window(n_fft))
    np.testing.assert_array_equal(
        mel.mel_filterbank(n_fft // 2 + 1, n_mels, SR),
        jax_mel.mel_filterbank(n_fft // 2 + 1, n_mels, SR))


@pytest.mark.parametrize("k,seconds", [(16, 1.0), (500, 0.5)])
def test_mirror_tokens_are_the_jax_mirrors(rng, k, seconds):
    """Seeded clips, unit-norm centroids: the port's mirror and the JAX
    package's give the same token ids, every frame, at the reference's
    thread count."""
    cents = _centroids(rng, k)
    clips = [rng.standard_normal(int(SR * seconds)).astype(np.float32)
             for _ in range(3)]
    port = torch_mirror.make_one_clip(SR, N_MELS, N_FFT, HOP, cents)
    assert torch.get_num_threads() == torch_mirror.REFERENCE_THREADS
    ref = jax_mirror.make_one_clip(SR, N_MELS, N_FFT, HOP, cents)
    for x in clips:
        got, want = port(x), ref(x)
        assert got.shape == (1 + len(x) // HOP,)
        assert torch.equal(got, want)


def test_best_of_3_rate_counts_clips_per_second(rng):
    calls = []
    rate = torch_mirror.best_of_3_rate([1, 2], calls.append)
    assert calls == [1, 2] * 3 and rate > 0


def test_bench_tokenizer_tiers_torch_mirror_row(threads):
    """``--torch-mirror`` on the CPU (the kernels' plain versions) at 1 s
    clips, batch 2, vocab 16: the last row is the mirror's, its tokens
    agree with the all-``highest`` kernel's on clip 0 at 99% or more, and
    the thread count is back where it was."""
    rows = bench_tokenizer_tiers.main([
        "--vocab", "16", "--batch", "2", "--seconds", "1", "--iters", "1",
        "--device", "cpu", "--torch-mirror"])
    assert [r["tier"] for r in rows] == [
        t for t, _ in bench_tokenizer_tiers.COMBOS] + ["torch-mirror"]
    mirror = rows[-1]
    assert mirror["vocab"] == 16
    assert mirror["threads"] == torch_mirror.REFERENCE_THREADS
    assert mirror["clips_per_s"] > 0
    assert mirror["ms"] == pytest.approx(1e3 / mirror["clips_per_s"])
    assert mirror["agreement"] >= 0.99
    assert torch.get_num_threads() == threads
