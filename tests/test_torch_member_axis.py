"""The member-axis rules of the kernels' custom ops on the CPU registrations
(the plain versions): ``torch.func.vmap`` over each of the six ``atk::``
LSTM and attention ops equals a loop over the members, bit for bit (the
rules call the op once a member, or once on the members folded into the
batch), and a vmapped forward followed by an ordinary ``.backward()``
gives each member the gradients of its own run.  Then the models' two
member seams (``models/members.py``): the dropout draw takes member k's
mask from generator k, and the recompute seam runs under the member axis.
The same rules on the card, with their launch counts, are in
``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import functional_call, stack_module_state, vmap

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.models import members
from audio_tokens_tpu_torch.ops import cuda_attention
from audio_tokens_tpu_torch.train.objective import weighted_bce

K, T, B, H = 3, 7, 2, 8
NH, T_ATT, DH = 2, 9, 64


def _rand(*shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def _mask(t, b, k=None, seed=0):
    """A prefix mask (T, B), or (K, T, B) with other lengths a member."""
    rng = np.random.default_rng(seed)
    n = 1 if k is None else k
    lens = rng.integers(1, t + 1, (n, b))
    m = (np.arange(t)[None, :, None] < lens[:, None, :]).astype(np.float32)
    m = torch.from_numpy(m)
    return m[0] if k is None else m


def _loop(op, args, dims):
    """The per-member loop the rule stands for, stacked."""
    outs = [op(*(a if d is None else a.select(d, i)
                 for a, d in zip(args, dims))) for i in range(K)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("carries", [False, True])
@pytest.mark.parametrize("shared_mask", [False, True])
def test_lstm_fwd_rule_equals_member_loop(carries, shared_mask):
    """B3 under the member axis: per-member ``w_hh`` and ``xg``, a shared
    or per-member mask, batched (h0, c0); residuals as asked."""
    xg = _rand(K, T, B, 4 * H, seed=1)
    w_hh = _rand(K, H, 4 * H, seed=2, scale=0.3)
    mask = _mask(T, B, seed=3) if shared_mask else _mask(T, B, K, seed=3)
    h0 = _rand(K, B, H, seed=4) if carries else None
    c0 = _rand(K, B, H, seed=5) if carries else None
    md = None if shared_mask else 0
    cd = 0 if carries else None
    for reverse in (False, True):
        for residuals in (False, True):
            def op(x, m, w, h, c):
                return torch.ops.atk.lstm_fwd(x, m, w, reverse, residuals,
                                              h, c)

            args, dims = (xg, mask, w_hh, h0, c0), (0, md, 0, cd, cd)
            _equal(vmap(op, in_dims=dims)(*args), _loop(op, args, dims))


def test_lstm_fwd_rule_member_axis_not_leading():
    """A member axis at dim 1 of xg (and h0 shared by every member)."""
    xg = _rand(T, K, B, 4 * H, seed=6)
    w_hh = _rand(K, H, 4 * H, seed=7, scale=0.3)
    mask = _mask(T, B, seed=8)
    h0, c0 = _rand(B, H, seed=9), _rand(B, H, seed=10)

    def op(x, m, w, h, c):
        return torch.ops.atk.lstm_fwd(x, m, w, False, True, h, c)

    args, dims = (xg, mask, w_hh, h0, c0), (1, None, 0, None, None)
    _equal(vmap(op, in_dims=dims)(*args), _loop(op, args, dims))


@pytest.mark.parametrize("carries", [False, True])
def test_lstm_backward_rules_equal_member_loop(carries):
    """B4's recurrence and ``dw_hh`` under the member axis."""
    gates = torch.sigmoid(_rand(K, T, B, 4 * H, seed=11))
    c = _rand(K, T, B, H, seed=12)
    hs, dhs = _rand(K, T, B, H, seed=13), _rand(K, T, B, H, seed=14)
    dh_last = _rand(K, B, H, seed=15)
    w_hh = _rand(K, H, 4 * H, seed=16, scale=0.3)
    mask = _mask(T, B, K, seed=17)
    dc_last = _rand(K, B, H, seed=18) if carries else None
    c0 = _rand(K, B, H, seed=19) if carries else None
    h0 = _rand(K, B, H, seed=20) if carries else None
    cd = 0 if carries else None

    def bwd(a, b_, g, cc, m, w, dcl, c0_):
        return torch.ops.atk.lstm_bwd(a, b_, g, cc, m, w, True, dcl, c0_)

    args = (dhs, dh_last, gates, c, mask, w_hh, dc_last, c0)
    dims = (0, 0, 0, 0, 0, 0, cd, cd)
    _equal(vmap(bwd, in_dims=dims)(*args), _loop(bwd, args, dims))

    def dw(h, d, h0_):
        return torch.ops.atk.lstm_dw(h, d, True, h0_)

    dxg = _rand(K, T, B, 4 * H, seed=21)
    args, dims = (hs, dxg, h0), (0, 0, cd)
    _equal(vmap(dw, in_dims=dims)(*args), _loop(dw, args, dims))


def _flash_inputs(dtype, seed):
    q, k, v = (_rand(K, B, NH, T_ATT, DH, seed=seed + i, scale=0.5)
               .to(dtype) for i in range(3))
    # prefix lengths with a 0 (a row that attends to nothing of its own)
    lens = torch.tensor([[0, T_ATT], [3, 5], [T_ATT, 1]])
    seg = (torch.arange(T_ATT)[None, None, :] >= lens[:, :, None]).int()
    return q, k, v, seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared_seg", [False, True])
def test_flash_rules_equal_member_loop(dtype, shared_seg):
    """B5's forward and its backward pair folded into the batch: equal to
    a loop over the members (segment ids per member or shared)."""
    q, k, v, seg = _flash_inputs(dtype, 30)
    sd = 0
    if shared_seg:
        seg, sd = seg[1], None
    for lse in (False, True):
        def fwd(q_, k_, v_, s_):
            return torch.ops.atk.flash_fwd(q_, k_, v_, s_, 0.125, lse)

        args, dims = (q, k, v, seg), (0, 0, 0, sd)
        _equal(vmap(fwd, in_dims=dims)(*args), _loop(fwd, args, dims))
    _, lse = vmap(lambda *a: torch.ops.atk.flash_fwd(*a, 0.125, True),
                  in_dims=(0, 0, 0, sd))(q, k, v, seg)
    do = _rand(K, B, NH, T_ATT, DH, seed=40).to(dtype)
    di = _rand(K, B, NH, T_ATT, seed=41)
    args, dims = (q, k, v, seg, lse, do, di), (0, 0, 0, sd, 0, 0, 0)
    for op in (torch.ops.atk.flash_bwd_dkv, torch.ops.atk.flash_bwd_dq):
        def bwd(*a, op=op):
            return op(*a, 0.125)

        _equal(vmap(bwd, in_dims=dims)(*args), _loop(bwd, args, dims))


def _lstm_members(seed_base=0):
    cfg = AudioTokensConfig(model_type="lstm", vocab_size=13, num_classes=5,
                            lstm_embed_dim=6, lstm_hidden_dim=H,
                            num_layers=2, max_seq_len=T)
    models = [get_model(cfg, "cpu", torch.Generator().manual_seed(seed_base
                                                                   + i))
              for i in range(K)]
    return cfg, models


def _batch(seed=50):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 13, (B, T), generator=g)
    lengths = torch.tensor([T, 3])
    y = (torch.rand((B, 5), generator=g) < 0.5).float()
    return x, lengths, y, torch.ones(B)


def test_vmapped_lstm_forward_backward_equals_members():
    """The ensemble's formulation: a forward vmapped over stacked
    parameters (B3 through its rule), then one ``.backward()`` of the
    summed member losses (B4 from each member's own autograd node): each
    member's loss and gradients are those of its own model."""
    _, models = _lstm_members()
    params, _ = stack_module_state(models)
    base = models[0]
    x, lengths, y, w = _batch()

    def member_loss(p):
        return weighted_bce(functional_call(base, p, (x, lengths)), y, w)

    losses = vmap(member_loss)(params)
    losses.sum().backward()
    for i, m in enumerate(models):
        loss = weighted_bce(m(x, lengths), y, w)
        loss.backward()
        torch.testing.assert_close(losses[i].detach(), loss.detach(),
                                   rtol=1e-6, atol=0)
        for name, p in m.named_parameters():
            torch.testing.assert_close(params[name].grad[i], p.grad,
                                       rtol=1e-6, atol=1e-7, msg=name)


def test_vmapped_flash_forward_backward_equals_members():
    """B5's fold under autograd: the members' gradients of q, k and v."""
    q, k, v, seg = (t.float() for t in _flash_inputs(torch.float32, 60))
    seg = seg.int()
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = vmap(lambda a, b_, c, s: cuda_attention.flash_attention(
        a, b_, c, s, 0.125))(*qkv, seg)
    (o * o).sum().backward()
    for i in range(K):
        mine = [t[i].clone().requires_grad_() for t in (q, k, v)]
        oi = cuda_attention.flash_attention(*mine, seg[i], 0.125)
        (oi * oi).sum().backward()
        assert torch.equal(o[i].detach(), oi.detach())
        for a, b_ in zip(qkv, mine):
            torch.testing.assert_close(a.grad[i], b_.grad, rtol=1e-6,
                                       atol=1e-7)


def test_member_uniform_draws_each_members_stream():
    """Under the member axis the draw seam takes member k's numbers from
    generator k, in the order a single model would draw them; outside it
    the seam is ``torch.rand`` on the caller's generator."""
    gens = [torch.Generator().manual_seed(100 + i) for i in range(K)]

    def draw(m):
        g = members.MemberGenerators(gens, m)
        return (members.uniform((2, 3), g, torch.device("cpu")),
                members.uniform((4,), g, torch.device("cpu")))

    a, b_ = vmap(draw)(torch.arange(K))
    for i in range(K):
        g = torch.Generator().manual_seed(100 + i)
        assert torch.equal(a[i], torch.rand((2, 3), generator=g))
        assert torch.equal(b_[i], torch.rand((4,), generator=g))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(members.uniform((3,), g1, torch.device("cpu")),
                       torch.rand((3,), generator=g2))


def test_member_generators_refuse_another_member_count():
    gens = [torch.Generator().manual_seed(i) for i in range(K)]
    with pytest.raises(ValueError, match="generators"):
        vmap(lambda m: members.uniform(
            (2,), members.MemberGenerators(gens, m), torch.device("cpu"))
        )(torch.arange(K + 1))


@pytest.mark.parametrize("chunk", [3, 16])
def test_vmapped_lstm_remat_equals_members(chunk):
    """``lstm_remat_chunk`` under the member axis (the recompute seam's
    rule: each member's chunks recomputed from its own carries): losses and
    gradients of each member's own model without remat."""
    cfg, models = _lstm_members(seed_base=10)
    remat = get_model(dataclasses.replace(cfg, lstm_remat_chunk=chunk),
                      "cpu", torch.Generator().manual_seed(0))
    params, _ = stack_module_state(models)
    x, lengths, y, w = _batch(51)

    def member_loss(p):
        return weighted_bce(functional_call(remat, p, (x, lengths)), y, w)

    losses = vmap(member_loss)(params)
    losses.sum().backward()
    for i, m in enumerate(models):
        loss = weighted_bce(m(x, lengths), y, w)
        loss.backward()
        torch.testing.assert_close(losses[i].detach(), loss.detach(),
                                   rtol=1e-6, atol=0)
        for name, p in m.named_parameters():
            torch.testing.assert_close(params[name].grad[i], p.grad,
                                       rtol=1e-5, atol=1e-6, msg=name)
