"""Kernels B3 and B4 (``csrc/lstm.cu``): one LSTM direction, forward and
backward, as ``torch.library`` custom ops joined by an autograd
registration.

B3 replaces ``audio_tokens_tpu/ops/pallas_lstm.py::_fwd_kernel`` (launched
by ``_lstm_fwd_call``), B4 ``_bwd_kernel`` (launched by ``_lstm_bwd_call``);
``lstm_sequence`` is the counterpart of the JAX ``lstm_sequence`` custom_vjp.
The T steps are serial, so on the H100 each step's small product, its
exchange between blocks through L2 and the barrier after it set the pace.
Each is one persistent cooperative launch.  B3's blocks own 8
hidden units x a share of the batch rows (``LstmShape`` in the source):
each keeps its units' gate columns of ``w_hh`` in shared memory, reads only
its rows of h each step and exchanges h through a double-buffered global
buffer.  B4's recurrence exchanges the pre-activation gate gradients, a
(B, 4H) plane every block must read its rows of each step: since the card
reads the plane once per group of units, its blocks own 8 (or 16) units x
a share of the batch rows, keep those units' rows of ``w_hh`` and run the
cell backward with (dh, dc) in registers; then a second kernel forms
``dw_hh`` as one product of the saved hidden states and those gradients,
split over K into slices whose partial tiles (scratch sized by the library)
a third small kernel adds in slice order.
The launch shapes are chosen in ``csrc/lstm.cu`` (``LstmShape``,
``LstmBwdShape``, ``DwShape``), and the
wrappers refuse a grid that cannot be resident at once (a cooperative launch
needs every block on the card together), asking the library both how many
blocks fit and how many the launch needs.

The state starts at zero, or at given carries (h0, c0): the lstm's chunked
recompute (``models/lstm.py``, ``lstm_remat_chunk``) runs a direction as
one launch a time chunk, each from the last chunk's (h_last, c_last), and
the backward returns the carries' gradients (dh0, dc0) and takes dc_last.

B3 writes the residuals B4 needs (post-activation gates and the cell carry
per step) only when asked: ``lstm_sequence`` asks only when autograd will
need them, so serving under ``inference_mode`` skips those stores.

Three custom ops, each with a CPU registration (the plain version), a CUDA
one (check, launch and count, or raise) and a fake (allocates only):
``atk::lstm_fwd`` (B3), ``atk::lstm_bwd`` (B4's recurrence) and
``atk::lstm_dw`` (B4's ``dw_hh``).  ``torch.library.register_autograd``
makes the second and third the first's backward, so ``torch.export``
records the kernels as nodes and a traced training step records B4 too.

Each op has a ``torch.library.register_vmap`` rule for an ensemble's
member axis (``train/ensemble.py``: ``torch.func.vmap`` over K members'
stacked parameters).  Every member has its own ``w_hh``, so a rule calls
the op once a member on the member's slices (shared mask, h0 or c0 as
they are) and stacks the outputs: on CUDA tensors, K launches of the
kernel.  The wrappers cannot see through the member axis whether autograd
will need B3's residuals, so the forward's rule asks the members' own
tensors.  Autograd records each member's call with its registered
backward, so in training B4 runs once a member from the graph; the
backward ops' rules serve a vmapped backward.

``lstm_sequence_scan`` is the plain recurrence as one
``torch._higher_order_ops.scan`` over ``lstm_sequence_fwd_plain``'s step
(``_lstm_step``, one definition for both), which ``torch.export`` keeps as
one loop where the Python loop would unroll into T steps.  A serving
program without kernels runs it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._higher_order_ops.scan import scan

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import (check_cuda_tensor, members,
                                               needs_grad)

MAX_BATCH = 256  # csrc/lstm.cu kMaxBatch


def lstm_sequence_fwd_plain(xg: torch.Tensor, mask: torch.Tensor,
                            w_hh: torch.Tensor, reverse: bool = False,
                            h0: Optional[torch.Tensor] = None,
                            c0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """xg (T, B, 4H), mask (T, B), w_hh (H, 4H) -> (hs (T, B, H), gates
    (T, B, 4H) post-activation, c (T, B, H) masked carry, h_last (B, H));
    a Python loop over time in ``_fwd_kernel``'s order, in xg's dtype, from
    the carries (h0, c0) (B, H) where given, else from zero."""
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    h = xg.new_zeros((b, h_dim)) if h0 is None else h0
    c = xg.new_zeros((b, h_dim)) if c0 is None else c0
    hs = xg.new_empty((t_steps, b, h_dim))
    gates = xg.new_empty((t_steps, b, g4))
    cs = xg.new_empty((t_steps, b, h_dim))
    order = range(t_steps - 1, -1, -1) if reverse else range(t_steps)
    for t in order:
        h, c, ifgo = _lstm_step(h, c, xg[t], mask[t], w_hh)
        hs[t] = h
        gates[t] = torch.cat(ifgo, dim=1)
        cs[t] = c
    return hs, gates, cs, h


def _lstm_step(h: torch.Tensor, c: torch.Tensor, x_t: torch.Tensor,
               m: torch.Tensor, w_hh: torch.Tensor):
    """One step of the plain recurrence, shared by the loop and the scan:
    (h, c) (B, H), x_t (B, 4H), m (B,) -> (h, c) after the masked carry,
    and the post-activation gates (i, f, g, o)."""
    i, f, g, o = (x_t + h @ w_hh).split(h.shape[1], dim=1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    m = m[:, None]
    h = m * h_new + (1.0 - m) * h
    c = m * c_new + (1.0 - m) * c
    return h, c, (i, f, g, o)


def lstm_sequence_scan(xg: torch.Tensor, mask: torch.Tensor,
                       w_hh: torch.Tensor, reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lstm_sequence_fwd_plain``'s (hs (T, B, H), h_last (B, H)) as one
    scan over time: the same step, so the same numbers."""

    def step(carry, inputs):
        h, c, _ = _lstm_step(*carry, *inputs, w_hh)
        return (h, c), h.clone()  # scan refuses an output aliasing the carry

    zeros = xg.new_zeros((xg.shape[1], xg.shape[2] // 4))
    (h_last, _), hs = scan(step, (zeros, zeros.clone()), (xg, mask),
                           reverse=reverse)
    return hs, h_last


def lstm_recurrence_bwd_plain(dhs: torch.Tensor, dh_last: torch.Tensor,
                              gates: torch.Tensor, c: torch.Tensor,
                              mask: torch.Tensor, w_hh: torch.Tensor,
                              reverse: bool = False,
                              dc_last: Optional[torch.Tensor] = None,
                              c0: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """B4's recurrence from B3's residuals -> (dxg (T, B, 4H) pre-activation
    gate gradients, dh0, dc0 (B, H) the gradients of the state the forward
    started from); a Python loop in ``_bwd_kernel``'s order: forward
    processing positions last to first, carrying (dh, dc) from (dh_last,
    dc_last or 0).  ``c0`` is the cell carry the forward started from (zero
    when None)."""
    t_steps, b, h_dim = c.shape
    t_of = (lambda p: t_steps - 1 - p) if reverse else (lambda p: p)
    dh = dh_last.clone()
    dc = torch.zeros_like(dh) if dc_last is None else dc_last.clone()
    dxg = gates.new_empty(gates.shape)
    for p in range(t_steps - 1, -1, -1):
        t = t_of(p)
        i, f, g, o = gates[t].split(h_dim, dim=1)
        tanh_c = torch.tanh(c[t])  # == tanh(c_new) wherever the step was live
        m = mask[t][:, None]
        dh_total = dhs[t] + dh
        dh_new = m * dh_total
        dh_prev_direct = (1.0 - m) * dh_total
        dc_new = m * dc
        dc_prev_direct = (1.0 - m) * dc
        d_o = dh_new * tanh_c
        dcn = dc_new + dh_new * o * (1.0 - tanh_c * tanh_c)
        if p > 0:
            c_prev = c[t_of(p - 1)]
        else:
            c_prev = torch.zeros_like(dc) if c0 is None else c0
        dc = dcn * f + dc_prev_direct
        dgp = torch.cat([dcn * g * i * (1.0 - i), dcn * c_prev * f * (1.0 - f),
                         dcn * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=1)
        dxg[t] = dgp
        dh = dgp @ w_hh.t() + dh_prev_direct
    return dxg, dh, dc


def lstm_sequence_bwd_plain(dhs: torch.Tensor, dh_last: torch.Tensor,
                            gates: torch.Tensor, c: torch.Tensor,
                            hs: torch.Tensor, mask: torch.Tensor,
                            w_hh: torch.Tensor, reverse: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of one direction from the zero state -> (dxg (T, B, 4H),
    dw_hh (H, 4H)): ``lstm_recurrence_bwd_plain`` then
    ``lstm_dw_hh_plain``."""
    dxg, _, _ = lstm_recurrence_bwd_plain(dhs, dh_last, gates, c, mask,
                                          w_hh, reverse)
    return dxg, lstm_dw_hh_plain(hs, dxg, reverse)


def lstm_dw_hh_plain(hs: torch.Tensor, dxg: torch.Tensor,
                     reverse: bool = False,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dw_hh (H, 4H) = the sum of h_prev(p)^T dxg(p) over processing
    positions p, accumulated step by step in ``_bwd_kernel``'s order (last
    to first); h_prev at p = 0 is h0, or the zero state, which adds
    nothing."""
    t_steps, _, h_dim = hs.shape
    t_of = (lambda p: t_steps - 1 - p) if reverse else (lambda p: p)
    dw = hs.new_zeros((h_dim, 4 * h_dim))
    for p in range(t_steps - 1, 0, -1):
        dw += hs[t_of(p - 1)].t() @ dxg[t_of(p)]
    if h0 is not None:
        dw += h0.t() @ dxg[t_of(0)]
    return dw


def _lib():
    lib = _build.load("lstm")
    if lib.atk_lstm_fwd.argtypes is None:
        P, I = _build.P, _build.I
        lib.atk_lstm_fwd.argtypes = [P, P, P, P, P, I, I, I, I, P, P, P, P,
                                     P, P, P]
        lib.atk_lstm_fwd.restype = I
        lib.atk_lstm_bwd.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, P,
                                     P, P, P, P]
        lib.atk_lstm_bwd.restype = I
        lib.atk_lstm_max_blocks.argtypes = [I, I, I,
                                            ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
        lib.atk_lstm_max_blocks.restype = I
        lib.atk_lstm_dw.argtypes = [P, P, P, I, I, I, I, P, P, P]
        lib.atk_lstm_dw.restype = I
        lib.atk_lstm_dw_scratch.argtypes = [I, I, I, I]
        lib.atk_lstm_dw_scratch.restype = _build.L
        lib.atk_lstm_fwd_scratch.argtypes = [I, I]
        lib.atk_lstm_fwd_scratch.restype = _build.L
    return lib


def _check_shapes(xg_shape, mask: torch.Tensor, w_hh: torch.Tensor) -> None:
    t_steps, b, g4 = xg_shape
    h_dim = g4 // 4
    if (g4 % 4 or tuple(mask.shape) != (t_steps, b)
            or tuple(w_hh.shape) != (h_dim, g4)):
        raise ValueError(f"shapes (T, B, 4H) {tuple(xg_shape)}, mask "
                         f"{tuple(mask.shape)}, w_hh {tuple(w_hh.shape)} "
                         "do not describe one LSTM direction")
    if t_steps < 1 or b < 1 or h_dim % 4 or b > MAX_BATCH:
        raise ValueError(f"kernel takes T >= 1, H % 4 == 0 and 1 <= B <= "
                         f"{MAX_BATCH}; got T {t_steps}, B {b}, H {h_dim}")


def _check_state(b: int, h_dim: int, device: torch.device,
                 **state: Optional[torch.Tensor]) -> None:
    """Raise unless the given (B, H) state tensors are all None or all
    contiguous f32 (B, H) on ``device``, 16-byte aligned (the dw_hh kernel
    copies h0's rows in 16-byte pieces)."""
    given = [t is not None for t in state.values()]
    if any(given) and not all(given):
        raise ValueError(f"{' and '.join(state)} go together: all or none")
    for name, t in state.items():
        if t is None:
            continue
        check_cuda_tensor(name, t, torch.float32, 2)
        if tuple(t.shape) != (b, h_dim) or t.device != device:
            raise ValueError(f"{name} must be ({b}, {h_dim}) on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_resident(lib, b: int, h_dim: int, backward: bool) -> None:
    resident, needed = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.atk_lstm_max_blocks(b, h_dim, int(backward),
                                              ctypes.byref(resident),
                                              ctypes.byref(needed)),
                 "lstm occupancy query")
    if resident.value < needed.value:
        raise RuntimeError(
            f"cooperative LSTM {'backward' if backward else 'forward'} grid "
            f"of {needed.value} blocks cannot be resident (device holds "
            f"{resident.value}; 0 means no cooperative launch)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# -- B3: atk::lstm_fwd -------------------------------------------------------
@torch.library.custom_op("atk::lstm_fwd", mutates_args=(),
                        device_types="cpu")
def _lstm_fwd_op(xg: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                 reverse: bool, residuals: bool,
                 h0: Optional[torch.Tensor] = None,
                 c0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """-> (hs, h_last, gates, c, c_last); gates and c are empty tensors
    unless ``residuals``."""
    hs, gates, c, h_last = lstm_sequence_fwd_plain(xg, mask, w_hh, reverse,
                                                   h0, c0)
    c_last = c[0 if reverse else -1].clone()
    if not residuals:
        gates, c = xg.new_empty(0), xg.new_empty(0)
    return hs, h_last, gates, c, c_last


@_lstm_fwd_op.register_kernel("cuda")
def _lstm_fwd_cuda(xg, mask, w_hh, reverse, residuals, h0=None, c0=None):
    check_cuda_tensor("xg", xg, torch.float32, 3)
    check_cuda_tensor("mask", mask, torch.float32, 2)
    check_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    _check_shapes(xg.shape, mask, w_hh)
    if len({xg.device, mask.device, w_hh.device}) != 1:
        raise ValueError("xg, mask and w_hh must share one device")
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    _check_state(b, h_dim, xg.device, h0=h0, c0=c0)
    lib = _lib()

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xg.device)

    hbuf = new(lib.atk_lstm_fwd_scratch(b, h_dim))  # h's planes, counters
    hs, h_last, c_last = new(t_steps, b, h_dim), new(b, h_dim), new(b, h_dim)
    gates = new(t_steps, b, g4) if residuals else new(0)
    c = new(t_steps, b, h_dim) if residuals else new(0)
    with torch.cuda.device(xg.device):
        _check_resident(lib, b, h_dim, backward=False)
        rc = lib.atk_lstm_fwd(
            xg.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), _ptr(h0),
            _ptr(c0), t_steps, b, h_dim, int(reverse), hbuf.data_ptr(),
            hs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            gates.data_ptr() if residuals else None,
            c.data_ptr() if residuals else None,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_fwd")
    lstm_sequence_fwd.launches += 1
    return hs, h_last, gates, c, c_last


@_lstm_fwd_op.register_fake
def _lstm_fwd_fake(xg, mask, w_hh, reverse, residuals, h0=None, c0=None):
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    if residuals:
        gates, c = xg.new_empty((t_steps, b, g4)), xg.new_empty(
            (t_steps, b, h_dim))
    else:
        gates, c = xg.new_empty(0), xg.new_empty(0)
    return (xg.new_empty((t_steps, b, h_dim)), xg.new_empty((b, h_dim)),
            gates, c, xg.new_empty((b, h_dim)))


# -- B4's recurrence: atk::lstm_bwd -----------------------------------------
@torch.library.custom_op("atk::lstm_bwd", mutates_args=(),
                        device_types="cpu")
def _lstm_bwd_op(dhs: torch.Tensor, dh_last: torch.Tensor,
                 gates: torch.Tensor, c: torch.Tensor, mask: torch.Tensor,
                 w_hh: torch.Tensor, reverse: bool,
                 dc_last: Optional[torch.Tensor] = None,
                 c0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dxg, dh0, dc0); dh0 and dc0 are empty tensors unless the
    forward started from carries (``c0`` given)."""
    dxg, dh0, dc0 = lstm_recurrence_bwd_plain(dhs, dh_last, gates, c, mask,
                                              w_hh, reverse, dc_last, c0)
    if c0 is None:
        dh0, dc0 = dhs.new_empty(0), dhs.new_empty(0)
    return dxg, dh0, dc0


@_lstm_bwd_op.register_kernel("cuda")
def _lstm_bwd_cuda(dhs, dh_last, gates, c, mask, w_hh, reverse,
                   dc_last=None, c0=None):
    for name, t, nd in (("dhs", dhs, 3), ("dh_last", dh_last, 2),
                        ("gates", gates, 3), ("c", c, 3), ("mask", mask, 2),
                        ("w_hh", w_hh, 2)):
        check_cuda_tensor(name, t, torch.float32, nd)
    _check_shapes(gates.shape, mask, w_hh)
    t_steps, b, g4 = gates.shape
    h_dim = g4 // 4
    for name, t, shape in (("dhs", dhs, (t_steps, b, h_dim)),
                           ("dh_last", dh_last, (b, h_dim)),
                           ("c", c, (t_steps, b, h_dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if len({t.device for t in (dhs, dh_last, gates, c, mask, w_hh)}) != 1:
        raise ValueError("the LSTM backward's tensors must share one device")
    _check_state(b, h_dim, dhs.device, dc_last=dc_last)
    _check_state(b, h_dim, dhs.device, c0=c0)
    lib = _lib()

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dhs.device)

    dgbuf, dxg = new(2, b, g4), new(t_steps, b, g4)
    dh0, dc0 = (new(b, h_dim), new(b, h_dim)) if c0 is not None else (
        new(0), new(0))
    with torch.cuda.device(dhs.device):
        _check_resident(lib, b, h_dim, backward=True)
        rc = lib.atk_lstm_bwd(
            dhs.data_ptr(), dh_last.data_ptr(), _ptr(dc_last),
            gates.data_ptr(), c.data_ptr(), mask.data_ptr(), w_hh.data_ptr(),
            _ptr(c0), t_steps, b, h_dim, int(reverse), dgbuf.data_ptr(),
            dxg.data_ptr(), dh0.data_ptr() if c0 is not None else None,
            dc0.data_ptr() if c0 is not None else None,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_bwd")
    lstm_sequence_bwd.launches += 1
    return dxg, dh0, dc0


@_lstm_bwd_op.register_fake
def _lstm_bwd_fake(dhs, dh_last, gates, c, mask, w_hh, reverse,
                   dc_last=None, c0=None):
    carry = (dh_last.new_empty(dh_last.shape) if c0 is not None
             else dh_last.new_empty(0))
    return gates.new_empty(gates.shape), carry, carry.new_empty(carry.shape)


# -- B4's dw_hh: atk::lstm_dw ------------------------------------------------
@torch.library.custom_op("atk::lstm_dw", mutates_args=(), device_types="cpu")
def _lstm_dw_op(hs: torch.Tensor, dxg: torch.Tensor, reverse: bool,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    return lstm_dw_hh_plain(hs, dxg, reverse, h0)


@_lstm_dw_op.register_kernel("cuda")
def _lstm_dw_cuda(hs, dxg, reverse, h0=None):
    check_cuda_tensor("hs", hs, torch.float32, 3)
    check_cuda_tensor("dxg", dxg, torch.float32, 3)
    t_steps, b, h_dim = hs.shape
    if tuple(dxg.shape) != (t_steps, b, 4 * h_dim) or dxg.device != hs.device:
        raise ValueError(f"dxg {tuple(dxg.shape)} does not match hs "
                         f"{tuple(hs.shape)}")
    if t_steps < 1 or b < 1 or h_dim < 1 or h_dim % 4:
        raise ValueError(f"kernel takes T >= 1, B >= 1 and H % 4 == 0; got "
                         f"T {t_steps}, B {b}, H {h_dim}")
    _check_state(b, h_dim, hs.device, h0=h0)
    lib = _lib()
    dw_hh = torch.empty((h_dim, 4 * h_dim), dtype=torch.float32,
                        device=hs.device)
    with torch.cuda.device(hs.device):
        floats = lib.atk_lstm_dw_scratch(t_steps, b, h_dim, int(h0 is not None))
        if floats < 0:
            raise RuntimeError("lstm dw_hh scratch query failed")
        # the split-K partial products (and h0's), none for one product
        scratch = torch.empty(floats, dtype=torch.float32, device=hs.device)
        rc = lib.atk_lstm_dw(hs.data_ptr(), dxg.data_ptr(), _ptr(h0), t_steps,
                             b, h_dim, int(reverse), scratch.data_ptr(),
                             dw_hh.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_dw")
    lstm_dw_hh.launches += 1
    return dw_hh


@_lstm_dw_op.register_fake
def _lstm_dw_fake(hs, dxg, reverse, h0=None):
    return hs.new_empty((hs.shape[2], 4 * hs.shape[2]))


# -- autograd: atk::lstm_fwd's backward is atk::lstm_bwd + atk::lstm_dw ------
def _lstm_fwd_setup(ctx, inputs, output):
    xg, mask, w_hh, reverse, residuals, h0, c0 = inputs
    hs, _, gates, c, _ = output
    ctx.set_materialize_grads(False)  # no zero planes for unused outputs
    ctx.reverse, ctx.residuals = reverse, residuals
    ctx.save_for_backward(gates, c, hs, mask, w_hh, h0, c0)


def _lstm_fwd_backward(ctx, dhs, dh_last, _dgates, _dc, dc_last):
    if not ctx.residuals:
        raise RuntimeError("atk::lstm_fwd ran with residuals=False: its "
                           "backward needs B3's residuals")
    gates, c, hs, mask, w_hh, h0, c0 = ctx.saved_tensors
    dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
    dh_last = (hs.new_zeros(hs.shape[1:]) if dh_last is None
               else dh_last.contiguous())
    if dc_last is not None:
        dc_last = dc_last.contiguous()
    dxg, dh0, dc0 = torch.ops.atk.lstm_bwd(dhs, dh_last, gates, c, mask,
                                           w_hh, ctx.reverse, dc_last, c0)
    dw_hh = torch.ops.atk.lstm_dw(hs, dxg, ctx.reverse, h0)
    if c0 is None:
        dh0 = dc0 = None
    return dxg, None, dw_hh, None, None, dh0, dc0


torch.library.register_autograd("atk::lstm_fwd", _lstm_fwd_backward,
                                setup_context=_lstm_fwd_setup)


# -- the member axis: torch.func.vmap over an ensemble's members --------------
def _per_member(op, info, in_dims, args, n_out: int):
    """Call ``op`` once a member on its slices (shared arguments as they
    are) and stack each output along a new leading member axis."""
    n = info.batch_size
    outs = [op(*row) for row in zip(*(members(a, d, n)
                                      for a, d in zip(args, in_dims)))]
    return (tuple(torch.stack([o[j] for o in outs]) for j in range(n_out)),
            (0,) * n_out)


def _padded(in_dims, n: int) -> tuple:
    """A rule's ``in_dims`` with None for the optional arguments the caller
    left out."""
    return tuple(in_dims) + (None,) * (n - len(in_dims))


@torch.library.register_vmap("atk::lstm_fwd")
def _lstm_fwd_vmap(info, in_dims, xg, mask, w_hh, reverse, residuals,
                   h0=None, c0=None):
    """B3 once a member (each member has its own ``w_hh``).  The wrapper
    cannot see through the member axis whether autograd needs B4's
    residuals, so the rule asks the members' tensors; it returns them only
    when the caller asked, since autograd keeps each member's own."""
    keep = residuals or needs_grad(xg, w_hh, h0, c0)
    in_dims = _padded(in_dims, 7)  # h0, c0 left out: no member axis
    (hs, h_last, gates, c, c_last), dims = _per_member(
        lambda *a: torch.ops.atk.lstm_fwd(*a[:3], reverse, keep, *a[3:]), info,
        in_dims[:3] + in_dims[5:], (xg, mask, w_hh, h0, c0), 5)
    if not residuals:
        gates = c = xg.new_empty((info.batch_size, 0))
    return (hs, h_last, gates, c, c_last), dims


@torch.library.register_vmap("atk::lstm_bwd")
def _lstm_bwd_vmap(info, in_dims, dhs, dh_last, gates, c, mask, w_hh,
                   reverse, dc_last=None, c0=None):
    """B4's recurrence once a member."""
    in_dims = _padded(in_dims, 9)
    dims = in_dims[:6] + in_dims[7:]
    return _per_member(
        lambda *a: torch.ops.atk.lstm_bwd(*a[:6], reverse, *a[6:]), info,
        dims, (dhs, dh_last, gates, c, mask, w_hh, dc_last, c0), 3)


@torch.library.register_vmap("atk::lstm_dw")
def _lstm_dw_vmap(info, in_dims, hs, dxg, reverse, h0=None):
    """B4's ``dw_hh`` once a member."""
    in_dims = _padded(in_dims, 4)
    (dw,), dims = _per_member(
        lambda h, d, h0_: (torch.ops.atk.lstm_dw(h, d, reverse, h0_),),
        info, (in_dims[0], in_dims[1], in_dims[3]), (hs, dxg, h0), 1)
    return dw, dims[0]


# -- the wrappers --------------------------------------------------------------
def lstm_sequence_fwd(xg: torch.Tensor, mask: torch.Tensor,
                      w_hh: torch.Tensor, reverse: bool = False,
                      residuals: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 Optional[torch.Tensor], torch.Tensor]:
    """B3: one LSTM direction over precomputed input gates (torch gate order
    i, f, g, o).  xg (T, B, 4H) f32 = x @ w_ih + bias; mask (T, B) f32
    prefix mask; w_hh (H, 4H) f32.  Returns (hs (T, B, H), gates, c, h_last
    (B, H)); gates (T, B, 4H) and c (T, B, H) are B4's residuals when
    ``residuals``, else None.  ``reverse`` walks time back to front and keeps
    hs in time order."""
    hs, h_last, gates, c, _ = torch.ops.atk.lstm_fwd(xg, mask, w_hh, reverse,
                                                     residuals)
    return (hs, gates, c, h_last) if residuals else (hs, None, None, h_last)


lstm_sequence_fwd.launches = 0


def lstm_sequence_bwd(dhs: torch.Tensor, dh_last: torch.Tensor,
                      gates: torch.Tensor, c: torch.Tensor, hs: torch.Tensor,
                      mask: torch.Tensor, w_hh: torch.Tensor,
                      reverse: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: the backward of ``lstm_sequence_fwd`` (from the zero state) from
    its residuals.  dhs (T, B, H) and dh_last (B, H) are the gradients of
    its two outputs; returns (dxg (T, B, 4H) = the pre-activation gate
    gradients, dw_hh (H, 4H)).  The mask gets no gradient.  Its count moves
    with the recurrence's launches."""
    dxg, _, _ = torch.ops.atk.lstm_bwd(dhs, dh_last, gates, c, mask, w_hh,
                                       reverse)
    return dxg, torch.ops.atk.lstm_dw(hs, dxg, reverse)


lstm_sequence_bwd.launches = 0


def lstm_dw_hh(hs: torch.Tensor, dxg: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """B4's ``dw_hh`` kernel: dw_hh (H, 4H) = the sum over processing
    positions p >= 1 of h_prev(p)^T dxg(p), from hs (T, B, H) and dxg
    (T, B, 4H) f32.  Every backward launches it after the recurrence; its
    count moves with each of those launches too."""
    return torch.ops.atk.lstm_dw(hs, dxg, reverse)


lstm_dw_hh.launches = 0


def lstm_sequence_carry(xg: torch.Tensor, mask: torch.Tensor,
                        w_hh: torch.Tensor, reverse: bool = False,
                        h0: Optional[torch.Tensor] = None,
                        c0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM direction from the carries (h0, c0) (B, H), or from zero
    when both are None -> (hs (T, B, H), h_last, c_last (B, H)),
    differentiable in xg, w_hh, h0 and c0 (B4 in the backward).  Where
    autograd will not need a gradient (grad mode off, or no input requires
    one), B3 runs without its residual stores."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xg, w_hh, h0, c0))
    hs, h_last, _, _, c_last = torch.ops.atk.lstm_fwd(xg, mask, w_hh,
                                                      reverse, grad, h0, c0)
    return hs, h_last, c_last


def lstm_sequence(xg: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                  reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM direction from the zero state, (hs (T, B, H), h_last
    (B, H)), as ``lstm_sequence_carry``."""
    hs, h_last, _ = lstm_sequence_carry(xg, mask, w_hh, reverse)
    return hs, h_last
