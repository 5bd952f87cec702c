"""Kernel B5's plain versions on the CPU against the library Pallas flash
attention the JAX package calls (``jax.experimental.pallas.ops.tpu.
flash_attention``), run in interpret mode with the JAX module's 256-wide
blocks and its padding of T to a block multiple.

Where T is a block multiple every row is compared.  Where it is not, JAX's
segment-1 queries also see the zero keys of its padding, so only the rows of
segment 0 (positions below each row's length) are compared: those are the
rows that reach the classifier.  Tolerances: f32 1e-5 (the same sums in
another order); bf16 2e-2 (P and the output each rounded to 8 bits, the
library rounding P against a running row max)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    DEFAULT_MASK_VALUE, BlockSizes, SegmentIds, _flash_attention_bwd_dkv,
    _flash_attention_bwd_dq, flash_attention as jax_flash)

from audio_tokens_tpu_torch.ops.cuda_attention import (
    _probs_and_ds, flash_attention, flash_attention_dkv_plain,
    flash_attention_dq_plain, flash_attention_fwd, flash_attention_plain)

BLOCK = 256  # audio_tokens_tpu/models/transformer.py _FLASH_BLOCK
SCALE = 0.125
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def interpret():
    """Run Pallas kernels by the generic interpreter (``pallas_call(...,
    interpret=True)``, as the JAX package's own kernel tests run them): the
    kernel becomes plain JAX ops.  TPU interpret mode (the default params)
    runs the kernel through host callbacks, and an op dispatched while those
    run can deadlock the CPU device queue."""
    return pltpu.force_tpu_interpret_mode(True)


def _inputs(rng, b, nh, t, lens):
    q, k, v, do = (rng.standard_normal((b, nh, t, 64)).astype(np.float32)
                   for _ in range(4))
    seg = (np.arange(t)[None, :] >= np.asarray(lens)[:, None]).astype(
        np.int32)
    return q, k, v, do, seg


def _jax_attention(q, k, v, seg, dtype):
    """The JAX module's call: pad T to a multiple of 256 (pad positions in
    segment 1), 256-wide blocks, slice the padding off."""
    t = q.shape[2]
    t_pad = -(-t // BLOCK) * BLOCK
    pad = ((0, 0), (0, 0), (0, t_pad - t), (0, 0))
    qj, kj, vj = (jnp.pad(jnp.asarray(a, dtype), pad) for a in (q, k, v))
    segj = jnp.pad(jnp.asarray(seg), ((0, 0), (0, t_pad - t)),
                   constant_values=1)
    bs = min(BLOCK, t_pad)
    blocks = BlockSizes(
        block_q=bs, block_k_major=bs, block_k=bs, block_b=1,
        block_q_major_dkv=bs, block_k_major_dkv=bs, block_k_dkv=bs,
        block_q_dkv=bs, block_k_major_dq=bs, block_k_dq=bs, block_q_dq=bs)

    def attend(qj, kj, vj):
        out = jax_flash(qj, kj, vj, segment_ids=SegmentIds(q=segj, kv=segj),
                        causal=False, sm_scale=SCALE, block_sizes=blocks)
        return out[:, :, :t, :]

    return jax.jit(attend), (qj, kj, vj)


def _valid_rows(seg, t):
    """(B, T) bool: the rows compared (see the module docstring)."""
    if t % BLOCK == 0:
        return np.ones(seg.shape, bool)
    return seg == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,lens", [
    (256, [256, 100, 0]),   # a block multiple: every row, a length-0 row
    (300, [300, 7, 0]),     # padded by JAX to 512: segment-0 rows
    # a ragged T with whole 64-row tiles of the other segment, as the
    # kernels leave out
    (200, [200, 64, 0]),
])
def test_plain_forward_matches_library_kernel(rng, dtype, t, lens):
    q, k, v, _, seg = _inputs(rng, 3, 2, t, lens)
    attend, args = _jax_attention(q, k, v, seg, dtype)
    with interpret():
        ref = np.asarray(attend(*args)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = flash_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(seg), SCALE)
    assert got.dtype == tdt
    rows = _valid_rows(seg, t)
    for i in range(3):
        np.testing.assert_allclose(got[i].float().numpy()[:, rows[i]],
                                   ref[i][:, rows[i]], **TOL[dtype])


# (200, [200, 64, 0]): a ragged T with whole 64-row tiles of the other
# segment, as the kernels leave out
@pytest.mark.parametrize("t,lens", [(256, [256, 90, 0]), (300, [300, 41]),
                                    (200, [200, 64, 0])])
def test_plain_backward_matches_library_kernels(rng, t, lens):
    """dq, dk, dv of ``flash_attention`` (its plain backward on the CPU) vs
    ``jax.grad`` through the library kernel, whose backward is its dk/dv and
    dq kernels; atol 1e-5.  The output gradient is zero on the rows not
    compared, so JAX's padding cannot reach the gradients."""
    b = len(lens)
    q, k, v, do, seg = _inputs(rng, b, 2, t, lens)
    do = do * _valid_rows(seg, t)[:, None, :, None]
    attend, args = _jax_attention(q, k, v, seg, "float32")

    def loss(qj, kj, vj):
        return jnp.sum(attend(qj, kj, vj) * do)

    with interpret():
        ref = [np.asarray(g)[:, :, :t] for g in
               jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, torch.from_numpy(seg), SCALE)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_is_autograd_of_plain_forward(rng, dtype):
    """The explicit backward (dk/dv and dq halves) equals torch autograd
    through ``flash_attention_plain``: f32 within 1e-5; bf16, where the
    explicit version rounds P and dS as the kernels do and autograd does
    not, within 2e-2 of the largest entry."""
    q, k, v, do, seg = (torch.from_numpy(a) for a in
                        _inputs(rng, 2, 2, 70, [70, 0]))
    q, k, v, do = (a.to(dtype) for a in (q, k, v, do))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    o, lse = flash_attention_plain(*leaves, seg, SCALE, True)
    ref = torch.autograd.grad(o, leaves, do)
    o, lse = o.detach(), lse.detach()
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_dkv_plain(q, k, v, seg, lse, do, di, SCALE)
    dq = flash_attention_dq_plain(q, k, v, seg, lse, do, di, SCALE)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert g.dtype == dtype, name
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)
        else:
            assert float((g - r).abs().max()) <= 2e-2 * float(
                r.abs().max()), name


def _three_segments(layout, b, t):
    """(b, t) int32 ids 0, 3 and 7, not a prefix: position by position
    (``interleaved``) or in thirds out of order, 7 then 0 then 3
    (``thirds``)."""
    pos = np.arange(t)
    if layout == "interleaved":
        row = np.array([0, 3, 7], np.int32)[pos % 3]
    else:
        row = np.array([7, 0, 3], np.int32)[pos * 3 // t]
    return np.tile(row, (b, 1))


@pytest.mark.parametrize("layout", ["interleaved", "thirds"])
def test_plain_dkv_dq_match_library_kernels_on_three_segments(rng, layout):
    """``flash_attention_dkv_plain`` / ``flash_attention_dq_plain`` vs the
    library's dk/dv and dq kernels called directly on the same residuals,
    with three segments whose ids are not 0/1 and not a prefix; T = 256, so
    the JAX side pads nothing.  f32, atol 1e-5 (the same sums in another
    order).  The library takes the row max m and sum l apart; the port their
    logsumexp."""
    b, nh, t = 2, 2, BLOCK
    q, k, v, do, _ = _inputs(rng, b, nh, t, [t] * b)
    seg = _three_segments(layout, b, t)
    tq, tk, tv, tdo, tseg = (torch.from_numpy(a) for a in (q, k, v, do, seg))
    same = tseg[:, None, :, None] == tseg[:, None, None, :]
    s = (tq @ tk.transpose(-1, -2)) * SCALE + torch.where(
        same, 0.0, DEFAULT_MASK_VALUE)
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    o, lse = flash_attention_plain(tq, tk, tv, tseg, SCALE, True)
    torch.testing.assert_close(lse, m + torch.log(l), atol=1e-5, rtol=1e-5)
    di = (o * tdo).sum(-1)
    args = (tq, tk, tv, tseg, lse, tdo, di, SCALE)
    got_dk, got_dv = flash_attention_dkv_plain(*args)
    got_dq = flash_attention_dq_plain(*args)

    segj = SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    common = dict(block_k_major=t, block_k=t, sm_scale=SCALE, causal=False,
                  mask_value=DEFAULT_MASK_VALUE, debug=False)

    def library(q, k, v, l, m, do, di):
        dk, dv = _flash_attention_bwd_dkv(
            q, k, v, None, segj, l, m, do, di, block_q_major=t, block_q=t,
            **common)
        dq, _ = _flash_attention_bwd_dq(
            q, k, v, None, segj, l, m, do, di, block_q_major=t, **common)
        return dq, dk, dv

    with interpret():
        ref = jax.jit(library)(*(jnp.asarray(a.numpy()) for a in
                                 (tq, tk, tv, l, m, tdo, di)))
    for name, g, r in zip(("dq", "dk", "dv"), (got_dq, got_dk, got_dv), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# a query block of T_Q rows (two JAX blocks' worth of keys: T_KV), rows
# [lo, lo + T_Q) of the window, as a sequence rank holds them
T_Q, T_KV = BLOCK, 2 * BLOCK


@pytest.mark.parametrize("lo", [0, 128, 256])
def test_plain_query_block_dkv_dq_match_library_kernels(rng, lo):
    """``flash_attention_dkv_plain`` / ``flash_attention_dq_plain`` on a
    query block (``kv_segment_ids``: T_Q query rows against T_KV keys) vs
    the library's dk/dv and dq kernels called directly with
    ``SegmentIds(q=seg[:, lo:lo + T_Q], kv=seg)``, 256-wide blocks (the
    dk/dv kernel walks one query block for each of two key blocks, dq two
    key blocks for its one query block); prefix lengths with a 0, one of
    them inside the block.  f32, atol 1e-5."""
    b, nh = 3, 2
    q, k, v, do, seg = _inputs(rng, b, nh, T_KV, [T_KV, lo + 70, 0])
    hi = lo + T_Q
    q, do, seg_q = q[:, :, lo:hi], do[:, :, lo:hi], seg[:, lo:hi]
    tq, tk, tv, tdo, tseg, tseg_q = (torch.from_numpy(np.ascontiguousarray(
        a)) for a in (q, k, v, do, seg, seg_q))
    same = tseg_q[:, None, :, None] == tseg[:, None, None, :]
    s = (tq @ tk.transpose(-1, -2)) * SCALE + torch.where(
        same, 0.0, DEFAULT_MASK_VALUE)
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    o, lse = flash_attention_plain(tq, tk, tv, tseg_q, SCALE, True,
                                   kv_segment_ids=tseg)
    di = (o * tdo).sum(-1)
    args = (tq, tk, tv, tseg_q, lse, tdo, di, SCALE, tseg)
    got_dk, got_dv = flash_attention_dkv_plain(*args)
    got_dq = flash_attention_dq_plain(*args)
    assert got_dk.shape == got_dv.shape == tk.shape
    assert got_dq.shape == tq.shape

    segj = SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg))
    common = dict(block_k_major=BLOCK, block_k=BLOCK, sm_scale=SCALE,
                  causal=False, mask_value=DEFAULT_MASK_VALUE, debug=False)

    def library(q, k, v, l, m, do, di):
        dk, dv = _flash_attention_bwd_dkv(
            q, k, v, None, segj, l, m, do, di, block_q_major=T_Q,
            block_q=T_Q, **common)
        dq, _ = _flash_attention_bwd_dq(
            q, k, v, None, segj, l, m, do, di, block_q_major=T_Q, **common)
        return dq, dk, dv

    with interpret():
        ref = jax.jit(library)(*(jnp.asarray(a.numpy()) for a in
                                 (tq, tk, tv, l, m, tdo, di)))
    for name, g, r in zip(("dq", "dk", "dv"), (got_dq, got_dk, got_dv), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("split", [96, 128, 1], ids=["ragged", "tile", "row"])
@pytest.mark.parametrize("layout", ["prefix", "thirds"])
def test_query_blocks_gradients_sum_to_the_full_window(rng, split, layout):
    """Autograd through ``flash_attention(..., kv_segment_ids=seg)`` on two
    query blocks that cover the window (as two sequence ranks run it): each
    block's dq is those rows of the full window's dq, and the blocks' dk
    and dv summed are the full window's (the sum the keys' gather takes in
    its backward).  f32, within 1e-6."""
    b, nh, t = 3, 2, 200
    q, k, v, do, seg = _inputs(rng, b, nh, t, [t, 64, 0])
    if layout == "thirds":
        seg = _three_segments(layout, b, t)
    q, k, v, do, seg = (torch.from_numpy(a) for a in (q, k, v, do, seg))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    full = torch.autograd.grad(flash_attention(*leaves, seg, SCALE), leaves,
                               do)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for lo, hi in ((0, split), (split, t)):
        leaves = [q[:, :, lo:hi].clone().requires_grad_(),
                  k.clone().requires_grad_(), v.clone().requires_grad_()]
        out = flash_attention(*leaves, seg[:, lo:hi].contiguous(), SCALE,
                              kv_segment_ids=seg)
        dq_b, dk_b, dv_b = torch.autograd.grad(out, leaves,
                                               do[:, :, lo:hi])
        assert dk_b.shape == k.shape and dq_b.shape == (b, nh, hi - lo, 64)
        torch.testing.assert_close(dq_b, full[0][:, :, lo:hi], atol=1e-6,
                                   rtol=1e-6)
        dk += dk_b
        dv += dv_b
    torch.testing.assert_close(dk, full[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv, full[2], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["interleaved", "thirds"])
def test_plain_forward_matches_library_kernel_on_three_segments(rng, layout,
                                                                dtype):
    """``flash_attention_plain`` vs the library forward kernel with three
    segments whose ids are not 0/1 and not a prefix (the layouts on which
    the card kernel leaves tiles out or walks them without tests); T = 256,
    so the JAX side pads nothing and every row is compared."""
    b, nh, t = 2, 2, BLOCK
    q, k, v, _, _ = _inputs(rng, b, nh, t, [t] * b)
    seg = _three_segments(layout, b, t)
    attend, args = _jax_attention(q, k, v, seg, dtype)
    with interpret():
        ref = np.asarray(attend(*args)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = flash_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(seg), SCALE)
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairs_of_different_segments_have_zero_p_and_ds(rng, dtype):
    """P and dS of the backward are exactly 0 wherever query and key lie in
    different segments (exp(MASK_VALUE - lse) underflows to 0), for any ids:
    a tile of such pairs contributes nothing to dq, dk or dv, which is what
    lets the kernels leave whole tiles out.  Same-segment pairs keep P > 0."""
    b, nh, t = 2, 2, 96
    q, k, v, do, _ = _inputs(rng, b, nh, t, [t] * b)
    seg = torch.from_numpy(_three_segments("interleaved", b, t))
    seg[1] = torch.from_numpy(_three_segments("thirds", 1, t)[0]) - 5
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o, lse = flash_attention_plain(q, k, v, seg, SCALE, True)
    di = (o.float() * do.float()).sum(-1)
    p, ds = _probs_and_ds(q, k, v, seg, lse, do, di, SCALE)
    other = (seg[:, None, :, None] != seg[:, None, None, :]).expand_as(p)
    assert other.any() and not other.all()
    assert torch.count_nonzero(p[other]) == 0
    assert torch.count_nonzero(ds[other]) == 0
    assert bool((p[~other] > 0).all())
    assert bool(torch.isfinite(ds).all())


def test_lse_is_the_row_logsumexp(rng):
    q, k, v, _, seg = (torch.from_numpy(a) for a in
                       _inputs(rng, 2, 1, 40, [40, 13]))
    _, lse = flash_attention_plain(q, k, v, seg, SCALE, True)
    s = (q @ k.transpose(-1, -2)) * SCALE
    same = seg[:, None, :, None] == seg[:, None, None, :]
    ref = torch.logsumexp(s.masked_fill(~same, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=1e-5)


def test_no_grad_forward_skips_lse_and_autograd(rng):
    """Serving (no gradient needed) runs the forward without the logsumexp
    and builds no graph; with a gradient it goes through the autograd
    registered on ``atk::flash_fwd``."""
    q, k, v, _, seg = (torch.from_numpy(a) for a in
                       _inputs(rng, 1, 2, 30, [30]))
    o, lse = flash_attention_fwd(q, k, v, seg, SCALE)
    assert lse is None
    with torch.inference_mode():
        o_i = flash_attention(q, k, v, seg, SCALE)
    assert o_i.grad_fn is None
    torch.testing.assert_close(o_i, o, atol=0, rtol=0)
    q.requires_grad_()
    o_g = flash_attention(q, k, v, seg, SCALE)
    assert "atk_flash_fwd" in type(o_g.grad_fn).__name__
    torch.testing.assert_close(o_g.detach(), o, atol=0, rtol=0)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before any build: a CPU tensor among CUDA ones, or a
    head dim other than 64, raise ValueError (checked without a card by
    handing the check CPU tensors directly)."""
    from audio_tokens_tpu_torch.ops import cuda_attention

    q = torch.zeros((1, 1, 8, 32))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention._check(q, q, q, seg)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_attention._check(q.half(), q.half(), q.half(), seg)
