"""Kernel B3 (``csrc/lstm.cu``): one LSTM direction, forward only.

Replaces ``audio_tokens_tpu/ops/pallas_lstm.py::_fwd_kernel`` (launched by
``_lstm_fwd_call``).  The T steps are serial, so on the H100 the kernel is
bound by the per-step exchange of h and the barrier between steps, not by
flops.  It is one persistent cooperative launch: each block keeps its slice
of ``w_hh`` (the four gate columns of 4 hidden units) in shared memory for
the whole sequence and computes the step's gates in 4 x 4 register tiles,
one thread per (batch row, unit) keeps the cell state in a register, and h
goes through a double-buffered global buffer with a grid barrier per step.
The wrapper refuses a grid that cannot be resident at once (a cooperative
launch needs every block on the card together).

The residuals of the TPU kernel (post-activation gates and c per step) feed
its backward kernel; they come with that backward, in the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from audio_tokens_tpu_torch.ops import _build
from audio_tokens_tpu_torch.ops.common import check_cuda_tensor

UNITS_PER_BLOCK = 4  # csrc/lstm.cu kUnits


def lstm_sequence_plain(xg: torch.Tensor, mask: torch.Tensor,
                        w_hh: torch.Tensor, reverse: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg (T, B, 4H), mask (T, B), w_hh (H, 4H) -> (hs (T, B, H), h_last
    (B, H)); a Python loop over time in the kernel's arithmetic order."""
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    h = xg.new_zeros((b, h_dim))
    c = xg.new_zeros((b, h_dim))
    hs = xg.new_empty((t_steps, b, h_dim))
    order = range(t_steps - 1, -1, -1) if reverse else range(t_steps)
    for t in order:
        gates = xg[t] + h @ w_hh
        i, f, g, o = gates.split(h_dim, dim=1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs[t] = h
    return hs, h


def _lib():
    lib = _build.load("lstm")
    if lib.atk_lstm_fwd.argtypes is None:
        P, I = _build.P, _build.I
        lib.atk_lstm_fwd.argtypes = [P, P, P, I, I, I, I, P, P, P, P]
        lib.atk_lstm_fwd.restype = I
        lib.atk_lstm_max_blocks.argtypes = [I, I, ctypes.POINTER(ctypes.c_int)]
        lib.atk_lstm_max_blocks.restype = I
    return lib


def lstm_sequence(xg: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                  reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM direction over precomputed input gates (torch gate order
    i, f, g, o).  xg (T, B, 4H) f32 = x @ w_ih + bias; mask (T, B) f32
    prefix mask; w_hh (H, 4H) f32.  Returns (hs (T, B, H), h_last (B, H));
    ``reverse`` walks time back to front and keeps hs in time order."""
    if xg.device.type == "cpu":
        return lstm_sequence_plain(xg, mask, w_hh, reverse)
    check_cuda_tensor("xg", xg, torch.float32, 3)
    check_cuda_tensor("mask", mask, torch.float32, 2)
    check_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    t_steps, b, g4 = xg.shape
    h_dim = g4 // 4
    if (g4 % 4 or tuple(mask.shape) != (t_steps, b)
            or tuple(w_hh.shape) != (h_dim, g4)):
        raise ValueError(f"shapes xg {tuple(xg.shape)}, mask "
                         f"{tuple(mask.shape)}, w_hh {tuple(w_hh.shape)} "
                         "do not describe one LSTM direction")
    if len({xg.device, mask.device, w_hh.device}) != 1:
        raise ValueError("xg, mask and w_hh must share one device")
    if (t_steps < 1 or b < 1 or h_dim % UNITS_PER_BLOCK
            or b * UNITS_PER_BLOCK > 1024):
        raise ValueError(f"kernel takes T >= 1, H % {UNITS_PER_BLOCK} == 0 "
                         f"and 1 <= B <= {1024 // UNITS_PER_BLOCK}; got T "
                         f"{t_steps}, B {b}, H {h_dim}")
    lib = _lib()
    hbuf = torch.empty((2, b, h_dim), dtype=torch.float32, device=xg.device)
    hs = torch.empty((t_steps, b, h_dim), dtype=torch.float32, device=xg.device)
    h_last = torch.empty((b, h_dim), dtype=torch.float32, device=xg.device)
    resident = ctypes.c_int(0)
    with torch.cuda.device(xg.device):
        _build.check(lib, lib.atk_lstm_max_blocks(b, h_dim,
                                                  ctypes.byref(resident)),
                     "lstm occupancy query")
        if resident.value < h_dim // UNITS_PER_BLOCK:
            raise RuntimeError(
                f"cooperative LSTM grid of {h_dim // UNITS_PER_BLOCK} blocks "
                f"cannot be resident (device holds {resident.value}; 0 means "
                "no cooperative launch)")
        rc = lib.atk_lstm_fwd(xg.data_ptr(), mask.data_ptr(),
                              w_hh.data_ptr(), t_steps, b, h_dim, int(reverse),
                              hbuf.data_ptr(), hs.data_ptr(),
                              h_last.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lstm_fwd")
    lstm_sequence.launches += 1
    return hs, h_last


lstm_sequence.launches = 0
