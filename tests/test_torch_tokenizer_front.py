"""B1's bf16 front end (``csrc/tokenizer.cu::tokenizer_wg_kernel``) on the
CPU: the items its ring streams decode to the tier's operands, its launch
plan takes every hop that divides n_fft and mel widths past 128 bands, and
the plain tier version at those shapes against the JAX kernel in interpret
mode (``check_tier_ties``, the tier's near-tie rule).
"""

import jax
import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops import pallas_tokenizer as jax_pt
from audio_tokens_tpu_torch.ops.cuda_tokenizer import (
    BAND_SLICE,
    BIN_PASS,
    ROW_STAGE,
    TokenizerKernel,
    front_items,
    tier_plan,
)
from audio_tokens_tpu_torch.ops.cuda_vq import MAX_SMEM
from audio_tokens_tpu_torch.ops.mel import MelFrontend
from audio_tokens_tpu_torch.ops.tiers import (
    check_tier_ties,
    round_bf16,
    tier_operands,
)
from audio_tokens_tpu_torch.ops.vq import l2_normalize

SR = 22050


def _decode(items: torch.Tensor, n_item: int, k_item: int, n_chunks: int,
            k_slices: int) -> torch.Tensor:
    """front_items' (n chunks, k slices, planes, n_item * k_item) back to
    (planes, N, K) f32."""
    planes = items.shape[2]
    x = items.float().reshape(n_chunks, k_slices, planes, n_item // 8,
                              k_item // 8, 8, 8)
    return x.permute(2, 0, 3, 5, 1, 4, 6).reshape(
        planes, n_chunks * n_item, k_slices * k_item)


@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("n_fft,hop,n_mels", [(256, 128, 32), (400, 100, 80),
                                              (512, 128, 256)])
def test_front_items_decode_to_the_tier_operands(n_fft, hop, n_mels, tier):
    """The basis items hold, per pass of 64 bins, re then im of its bins x
    64-sample slabs, the filterbank items 64-band slices x the pass's bins,
    each plane the tier's split of the f32 operand (zeros past the real
    samples, bins and bands)."""
    kern = TokenizerKernel(SR, n_mels, n_fft, hop, 10,
                           np.ones((3, n_mels), np.float32), "cpu", tier)
    nb = n_fft // 2
    trows = -(-n_fft // ROW_STAGE) * ROW_STAGE
    passes = -(-nb // BIN_PASS)
    mslices = -(-n_mels // BAND_SLICE)
    planes = 2 if tier == "bf16x3" else 1
    assert kern._tbasis.shape == (passes * trows // ROW_STAGE, planes,
                                  2 * BIN_PASS * ROW_STAGE)
    assert kern._tfbank.shape == (passes * mslices, planes,
                                  BAND_SLICE * BIN_PASS)
    basis = _decode(kern._tbasis.reshape(passes, trows // ROW_STAGE,
                                         planes, -1),
                    2 * BIN_PASS, ROW_STAGE, passes, trows // ROW_STAGE)
    want = torch.zeros((passes, 2, BIN_PASS, trows))
    re = torch.zeros((passes * BIN_PASS, trows))
    im = torch.zeros_like(re)
    re[:nb, :n_fft] = kern.basis[:, :nb].T
    im[:nb, :n_fft] = kern.basis[:, nb:].T
    want[:, 0] = re.view(passes, BIN_PASS, trows)
    want[:, 1] = im.view(passes, BIN_PASS, trows)
    for got, ref in zip(basis, tier_operands(want.reshape(-1, trows), tier)):
        assert torch.equal(got, ref)
    fb = _decode(kern._tfbank.reshape(passes, mslices, planes, -1)
                 .transpose(0, 1), BAND_SLICE, BIN_PASS, mslices, passes)
    want = torch.zeros((mslices * BAND_SLICE, passes * BIN_PASS))
    want[:n_mels, :nb] = kern.fbank.T
    for got, ref in zip(fb, tier_operands(want, tier)):
        assert torch.equal(got, ref)


def test_front_items_are_core_matrices():
    """One item's plane: 128-byte core matrices of 8 rows x 8 k values, in
    (8-row group, 8-k block) order."""
    mat = round_bf16(torch.arange(16 * 32, dtype=torch.float32)
                     .reshape(16, 32))
    items = front_items(mat, "default", 16, 32)
    assert items.shape == (1, 1, 1, 512)
    flat = items[0, 0, 0].float()
    assert torch.equal(flat[:8], mat[0, :8])      # core (0, 0), row 0
    assert torch.equal(flat[8:16], mat[1, :8])    # core (0, 0), row 1
    assert torch.equal(flat[64:72], mat[0, 8:16])  # core (0, 1), row 0
    assert torch.equal(flat[256:264], mat[8, :8])  # core (1, 0), row 0


# (n_fft, hop, n_mels): every hop that divides n_fft at the package's n_fft
# and at 400 (hop 200 and 100: off 16, and off 8), mel widths past 128
PLAN_SHAPES = ([(512, h, 64) for h in (512, 256, 128, 64, 32, 16, 8, 4, 2,
                                       1)]
               + [(400, h, 64) for h in (400, 200, 100, 80, 50, 40, 25, 16,
                                         10, 8, 5)]
               + [(512, 128, m) for m in (128, 130, 200, 256)]
               + [(400, 80, 256), (400, 200, 256), (400, 100, 256)])


@pytest.mark.parametrize("vq_tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_front_plan_takes_every_hop_and_wide_mels(tier, vq_tier):
    for n_fft, hop, m in PLAN_SHAPES:
        trows = -(-n_fft // ROW_STAGE) * ROW_STAGE
        frames, stages, smem = tier_plan(hop, trows, m, tier, vq_tier)
        assert frames in (64, 128) and stages >= 2, (n_fft, hop, m)
        assert smem <= MAX_SMEM
    # the package defaults keep 128 frames a block and a ring of 3 stages
    # (bf16x3: two planes of 16 KB an item) or 8 (default)
    assert tier_plan(128, 512, 64, tier, vq_tier)[:2] == (
        128, 3 if tier == "bf16x3" else 8)


def _tokens_pair(tier, n_fft, hop, n_mels, vocab=40, seed=8):
    """(port plain tokens, JAX interpret tokens, port features, centroids)
    at (tier, tier)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((vocab, n_mels)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    fe = MelFrontend("cpu", SR, n_mels, n_fft, hop, SR // 2)
    frames = fe.frames_max
    jk = jax_pt.TokenizerKernel(SR, n_mels, n_fft, hop, frames, cents,
                                tier=tier, vq_tier=tier, interpret=True)
    clips = [rng.standard_normal(int(SR * s)).astype(np.float32) * a
             for s, a in ((0.5, 1.0), (0.4, 0.3), (0.5, 2.0))]
    batch, _ = fe.prepare_batch(clips)
    wide = np.zeros((len(batch), jk.n_blocks * hop), np.float32)
    wide[:, :batch.shape[1]] = batch
    ref = np.array(jk(jax.numpy.asarray(wide)))
    pk = TokenizerKernel(SR, n_mels, n_fft, hop, frames, cents, "cpu", tier,
                         tier)
    x = torch.from_numpy(wide)
    got = pk(x)
    assert torch.equal(got, pk.plain(x))
    return got, torch.from_numpy(ref), l2_normalize(pk.log_mel_plain(x)), \
        pk.centroids


@pytest.mark.parametrize("n_fft,hop,n_mels", [(400, 200, 64), (400, 100, 64),
                                              (512, 256, 256)])
def test_plain_tier_tokens_at_the_new_shapes_match_jax_interpret(
        n_fft, hop, n_mels):
    """The shapes the bf16 front end took up (hop off 16, off 8; 256 mel
    bands): the port's plain bf16x3 tokens (what the card's kernel is held
    to) against the JAX kernel's, under the bf16x3 near-tie rule."""
    got, ref, feats, cents = _tokens_pair("bf16x3", n_fft, hop, n_mels)
    check_tier_ties(feats, cents, got, ref, "bf16x3")
