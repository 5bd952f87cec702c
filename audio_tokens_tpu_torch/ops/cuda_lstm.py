"""Kernels B3 and B4 (``csrc/lstm.cu``): one LSTM direction, forward and
backward, and the ``torch.autograd.Function`` that joins them.

B3 replaces ``audio_tokens_tpu/ops/pallas_lstm.py::_fwd_kernel`` (launched
by ``_lstm_fwd_call``), B4 ``_bwd_kernel`` (launched by ``_lstm_bwd_call``);
``LSTMSequence`` is the counterpart of the JAX ``lstm_sequence`` custom_vjp.
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

B3 writes the residuals B4 needs (post-activation gates and the cell carry
per step) only when asked: ``lstm_sequence`` asks only when autograd will
need them, so serving under ``inference_mode`` skips those stores.

Each wrapper runs its plain PyTorch version for CPU tensors; for CUDA
tensors it launches its kernel or raises.  B3's wrapper does so through
the custom op ``atk::lstm_fwd``, so that ``torch.export`` records the
kernel as one node: the op's CPU registration is the plain version, its
CUDA registration launches B3 (and counts the launch), and its fake only
allocates the outputs.  B4 stays a direct call (training only).

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
from torch.autograd.function import once_differentiable

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor

MAX_BATCH = 256  # csrc/lstm.cu kMaxBatch


def lstm_sequence_fwd_plain(xg: torch.Tensor, mask: torch.Tensor,
                            w_hh: torch.Tensor, reverse: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """xg (T, B, 4H), mask (T, B), w_hh (H, 4H) -> (hs (T, B, H), gates
    (T, B, 4H) post-activation, c (T, B, H) masked carry, h_last (B, H));
    a Python loop over time in ``_fwd_kernel``'s order, in xg's dtype."""
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    h = xg.new_zeros((b, h_dim))
    c = xg.new_zeros((b, h_dim))
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


def lstm_sequence_bwd_plain(dhs: torch.Tensor, dh_last: torch.Tensor,
                            gates: torch.Tensor, c: torch.Tensor,
                            hs: torch.Tensor, mask: torch.Tensor,
                            w_hh: torch.Tensor, reverse: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of one direction from its residuals -> (dxg (T, B, 4H)
    pre-activation gate gradients, dw_hh (H, 4H)); a Python loop in
    ``_bwd_kernel``'s order: forward processing positions last to first,
    carrying (dh, dc) from (dh_last, 0)."""
    t_steps, b, h_dim = hs.shape
    t_of = (lambda p: t_steps - 1 - p) if reverse else (lambda p: p)
    dh = dh_last.clone()
    dc = torch.zeros_like(dh)
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
        c_prev = c[t_of(p - 1)] if p > 0 else torch.zeros_like(dc)
        dc = dcn * f + dc_prev_direct
        dgp = torch.cat([dcn * g * i * (1.0 - i), dcn * c_prev * f * (1.0 - f),
                         dcn * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=1)
        dxg[t] = dgp
        dh = dgp @ w_hh.t() + dh_prev_direct
    return dxg, lstm_dw_hh_plain(hs, dxg, reverse)


def lstm_dw_hh_plain(hs: torch.Tensor, dxg: torch.Tensor,
                     reverse: bool = False) -> torch.Tensor:
    """dw_hh (H, 4H) = the sum of h_prev(p)^T dxg(p) over processing
    positions p, accumulated step by step in ``_bwd_kernel``'s order (last
    to first); h_prev is the zero state at p = 0, which adds nothing."""
    t_steps, _, h_dim = hs.shape
    t_of = (lambda p: t_steps - 1 - p) if reverse else (lambda p: p)
    dw = hs.new_zeros((h_dim, 4 * h_dim))
    for p in range(t_steps - 1, 0, -1):
        dw += hs[t_of(p - 1)].t() @ dxg[t_of(p)]
    return dw


def _lib():
    lib = _build.load("lstm")
    if lib.atk_lstm_fwd.argtypes is None:
        P, I = _build.P, _build.I
        lib.atk_lstm_fwd.argtypes = [P, P, P, I, I, I, I, P, P, P, P, P, P]
        lib.atk_lstm_fwd.restype = I
        lib.atk_lstm_bwd.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P, P, P,
                                     P, P]
        lib.atk_lstm_bwd.restype = I
        lib.atk_lstm_max_blocks.argtypes = [I, I, I,
                                            ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
        lib.atk_lstm_max_blocks.restype = I
        lib.atk_lstm_dw.argtypes = [P, P, I, I, I, I, P, P, P]
        lib.atk_lstm_dw.restype = I
        lib.atk_lstm_dw_scratch.argtypes = [I, I, I]
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


@torch.library.custom_op("atk::lstm_fwd", mutates_args=(),
                        device_types="cpu")
def _lstm_fwd_op(xg: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                 reverse: bool, residuals: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """-> (hs, h_last, gates, c); gates and c are empty tensors unless
    ``residuals``."""
    hs, gates, c, h_last = lstm_sequence_fwd_plain(xg, mask, w_hh, reverse)
    if not residuals:
        gates, c = xg.new_empty(0), xg.new_empty(0)
    return hs, h_last, gates, c


@_lstm_fwd_op.register_kernel("cuda")
def _lstm_fwd_cuda(xg, mask, w_hh, reverse, residuals):
    check_cuda_tensor("xg", xg, torch.float32, 3)
    check_cuda_tensor("mask", mask, torch.float32, 2)
    check_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    _check_shapes(xg.shape, mask, w_hh)
    if len({xg.device, mask.device, w_hh.device}) != 1:
        raise ValueError("xg, mask and w_hh must share one device")
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    lib = _lib()

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xg.device)

    hbuf = new(lib.atk_lstm_fwd_scratch(b, h_dim))  # h's planes, counters
    hs, h_last = new(t_steps, b, h_dim), new(b, h_dim)
    gates = new(t_steps, b, g4) if residuals else new(0)
    c = new(t_steps, b, h_dim) if residuals else new(0)
    with torch.cuda.device(xg.device):
        _check_resident(lib, b, h_dim, backward=False)
        rc = lib.atk_lstm_fwd(
            xg.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), t_steps, b,
            h_dim, int(reverse), hbuf.data_ptr(), hs.data_ptr(),
            h_last.data_ptr(), gates.data_ptr() if residuals else None,
            c.data_ptr() if residuals else None,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_fwd")
    lstm_sequence_fwd.launches += 1
    return hs, h_last, gates, c


@_lstm_fwd_op.register_fake
def _lstm_fwd_fake(xg, mask, w_hh, reverse, residuals):
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    if residuals:
        gates, c = xg.new_empty((t_steps, b, g4)), xg.new_empty(
            (t_steps, b, h_dim))
    else:
        gates, c = xg.new_empty(0), xg.new_empty(0)
    return (xg.new_empty((t_steps, b, h_dim)), xg.new_empty((b, h_dim)),
            gates, c)


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
    hs, h_last, gates, c = torch.ops.atk.lstm_fwd(xg, mask, w_hh, reverse,
                                                  residuals)
    return (hs, gates, c, h_last) if residuals else (hs, None, None, h_last)


lstm_sequence_fwd.launches = 0


def lstm_sequence_bwd(dhs: torch.Tensor, dh_last: torch.Tensor,
                      gates: torch.Tensor, c: torch.Tensor, hs: torch.Tensor,
                      mask: torch.Tensor, w_hh: torch.Tensor,
                      reverse: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: the backward of ``lstm_sequence_fwd`` from its residuals.  dhs
    (T, B, H) and dh_last (B, H) are the gradients of its two outputs;
    returns (dxg (T, B, 4H) = the pre-activation gate gradients, dw_hh
    (H, 4H)).  The mask gets no gradient."""
    if dhs.device.type == "cpu":
        return lstm_sequence_bwd_plain(dhs, dh_last, gates, c, hs, mask,
                                       w_hh, reverse)
    for name, t, nd in (("dhs", dhs, 3), ("dh_last", dh_last, 2),
                        ("gates", gates, 3), ("c", c, 3), ("hs", hs, 3),
                        ("mask", mask, 2), ("w_hh", w_hh, 2)):
        check_cuda_tensor(name, t, torch.float32, nd)
    _check_shapes(gates.shape, mask, w_hh)
    t_steps, b, g4 = gates.shape
    h_dim = g4 // 4
    for name, t, shape in (("dhs", dhs, (t_steps, b, h_dim)),
                           ("dh_last", dh_last, (b, h_dim)),
                           ("c", c, (t_steps, b, h_dim)),
                           ("hs", hs, (t_steps, b, h_dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if len({t.device for t in (dhs, dh_last, gates, c, hs, mask, w_hh)}) != 1:
        raise ValueError("the LSTM backward's tensors must share one device")
    lib = _lib()
    dgbuf = torch.empty((2, b, g4), dtype=torch.float32, device=dhs.device)
    dxg = torch.empty((t_steps, b, g4), dtype=torch.float32, device=dhs.device)
    dw_hh = torch.empty((h_dim, g4), dtype=torch.float32, device=dhs.device)
    with torch.cuda.device(dhs.device):
        _check_resident(lib, b, h_dim, backward=True)
        scratch = _dw_scratch(lib, t_steps, b, h_dim, dhs.device)
        rc = lib.atk_lstm_bwd(
            dhs.data_ptr(), dh_last.data_ptr(), gates.data_ptr(),
            c.data_ptr(), hs.data_ptr(), mask.data_ptr(), w_hh.data_ptr(),
            t_steps, b, h_dim, int(reverse), dgbuf.data_ptr(),
            scratch.data_ptr(), dxg.data_ptr(), dw_hh.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_bwd")
    lstm_sequence_bwd.launches += 1
    return dxg, dw_hh


lstm_sequence_bwd.launches = 0


def _dw_scratch(lib, t_steps: int, b: int, h_dim: int,
                device: torch.device) -> torch.Tensor:
    """The split-K partial products of dw_hh's GEMM, sized by the library
    for the current device (empty when it takes one slice)."""
    floats = lib.atk_lstm_dw_scratch(t_steps, b, h_dim)
    if floats < 0:
        raise RuntimeError("lstm dw_hh scratch query failed")
    return torch.empty(floats, dtype=torch.float32, device=device)


def lstm_dw_hh(hs: torch.Tensor, dxg: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """B4's second kernel alone, for timing it apart from the recurrence:
    dw_hh (H, 4H) = the sum over processing positions p >= 1 of
    h_prev(p)^T dxg(p), from hs (T, B, H) and dxg (T, B, 4H) f32.
    ``lstm_sequence_bwd`` launches the same kernel after the recurrence.
    A CPU tensor takes the plain version ``lstm_dw_hh_plain``."""
    if hs.device.type == "cpu":
        return lstm_dw_hh_plain(hs, dxg, reverse)
    check_cuda_tensor("hs", hs, torch.float32, 3)
    check_cuda_tensor("dxg", dxg, torch.float32, 3)
    t_steps, b, h_dim = hs.shape
    if tuple(dxg.shape) != (t_steps, b, 4 * h_dim) or dxg.device != hs.device:
        raise ValueError(f"dxg {tuple(dxg.shape)} does not match hs "
                         f"{tuple(hs.shape)}")
    if t_steps < 1 or b < 1 or h_dim < 1 or h_dim % 4:
        raise ValueError(f"kernel takes T >= 1, B >= 1 and H % 4 == 0; got "
                         f"T {t_steps}, B {b}, H {h_dim}")
    lib = _lib()
    dw_hh = torch.empty((h_dim, 4 * h_dim), dtype=torch.float32,
                        device=hs.device)
    with torch.cuda.device(hs.device):
        scratch = _dw_scratch(lib, t_steps, b, h_dim, hs.device)
        rc = lib.atk_lstm_dw(hs.data_ptr(), dxg.data_ptr(), t_steps, b, h_dim,
                             int(reverse), scratch.data_ptr(),
                             dw_hh.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_dw")
    lstm_dw_hh.launches += 1
    return dw_hh


lstm_dw_hh.launches = 0


class LSTMSequence(torch.autograd.Function):
    """(xg, mask, w_hh, reverse) -> (hs, h_last) with B3 forward and B4
    backward (their plain versions for CPU tensors); the counterpart of the
    JAX ``lstm_sequence`` custom_vjp, saving the same residuals."""

    @staticmethod
    def forward(ctx, xg, mask, w_hh, reverse):
        hs, gates, c, h_last = lstm_sequence_fwd(xg, mask, w_hh, reverse,
                                                 residuals=True)
        ctx.reverse = reverse
        ctx.save_for_backward(gates, c, hs, mask, w_hh)
        return hs, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dhs, dh_last):
        gates, c, hs, mask, w_hh = ctx.saved_tensors
        dxg, dw_hh = lstm_sequence_bwd(dhs.contiguous(), dh_last.contiguous(),
                                       gates, c, hs, mask, w_hh, ctx.reverse)
        return dxg, None, dw_hh, None


def lstm_sequence(xg: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                  reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM direction, (hs (T, B, H), h_last (B, H)), differentiable in
    xg and w_hh through ``LSTMSequence``.  Where autograd will not need a
    gradient (grad mode off, or no input requires one), B3 runs without its
    residual stores."""
    if torch.is_grad_enabled() and (xg.requires_grad or w_hh.requires_grad):
        return LSTMSequence.apply(xg, mask, w_hh, reverse)
    hs, _, _, h_last = lstm_sequence_fwd(xg, mask, w_hh, reverse)
    return hs, h_last
