"""Pure-python FLAC decoder (correctness reference / fallback path).

A copy of ``audio_tokens_tpu/data/flac.py`` (numpy only), held bit-equal to
the original by ``tests/test_torch_audio_io.py``.

The reference reads AudioSet ``.flac`` clips through torchaudio's C++ backend
(reference: processors/spectrogram_generator.py:99).  This is a complete,
dependency-free decoder for the FLAC subset that AudioSet uses (16-bit,
1-2 channels, all subframe types: CONSTANT / VERBATIM / FIXED 0-4 / LPC, rice
and rice2 residual coding, all stereo decorrelation modes).

It is deliberately simple — the production decode path is the native C++
decoder in ``native/`` (built via ``python native/build.py``), which is
validated against this implementation on the same fixtures.  Pure python
decodes ~0.1-1 MB/s; fine for tests and small runs, not for the 2M-clip
corpus.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


class FlacError(RuntimeError):
    pass


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.pos = byte_pos * 8  # bit position

    def read(self, n: int) -> int:
        """Read n bits, MSB-first."""
        result = 0
        pos = self.pos
        data = self.data
        end = pos + n
        if end > len(data) * 8:
            raise FlacError("unexpected end of stream")
        while n > 0:
            byte = data[pos >> 3]
            bit_off = pos & 7
            avail = 8 - bit_off
            take = min(avail, n)
            shift = avail - take
            mask = (1 << take) - 1
            result = (result << take) | ((byte >> shift) & mask)
            pos += take
            n -= take
        self.pos = pos
        return result

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        count = 0
        while self.read(1) == 0:
            count += 1
        return count

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_utf8_number(self) -> int:
        """UTF-8-style variable length number (frame header sample/frame no)."""
        first = self.read(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        if n_extra == 0:
            raise FlacError("invalid UTF-8 coded number")
        value = first & (mask - 1)
        for _ in range(n_extra):
            b = self.read(8)
            if (b & 0xC0) != 0x80:
                raise FlacError("invalid UTF-8 continuation")
            value = (value << 6) | (b & 0x3F)
        return value


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZE_CODES = {1: 192}
for _i in range(2, 6):
    _BLOCK_SIZE_CODES[_i] = 576 << (_i - 2)
for _i in range(8, 16):
    _BLOCK_SIZE_CODES[_i] = 256 << (_i - 8)

_SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

def _decode_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    if order > block_size:
        raise FlacError("subframe order exceeds block size")
    partition_order = br.read(4)
    n_partitions = 1 << partition_order
    if block_size % n_partitions:
        raise FlacError("invalid partition order")
    if partition_order > 0 and (block_size >> partition_order) <= order:
        # libFLAC validates this: the warm-up must fit the FIRST partition
        # or the partition sample counts go inconsistent (the C++ twin
        # rejects identically)
        raise FlacError("partition order incompatible with predictor order")
    residual = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(n_partitions):
        n = block_size >> partition_order
        if p == 0:
            n -= order
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            for i in range(n):
                residual[idx + i] = br.read_signed(raw_bits) if raw_bits else 0
        else:
            for i in range(n):
                q = br.read_unary()
                r = br.read(param) if param else 0
                v = (q << param) | r
                residual[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += n
    return residual


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise FlacError("invalid subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):  # wasted bits flag
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = np.full(block_size, v, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.empty(block_size, dtype=np.int64)
        for i in range(block_size):
            out[i] = br.read_signed(bps)
    elif 8 <= sf_type <= 12:  # FIXED, order = sf_type - 8
        order = sf_type - 8
        warmup = [br.read_signed(bps) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warmup
        coeffs = _FIXED_COEFFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * out[i - 1 - j]
            out[i] = residual[i - order] + pred
    elif sf_type >= 32:  # LPC, order = sf_type - 31
        order = sf_type - 31
        warmup = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warmup
        for i in range(order, block_size):
            pred = 0
            for j in range(order):
                pred += coeffs[j] * int(out[i - 1 - j])
            out[i] = residual[i - order] + (pred >> shift)
    else:
        raise FlacError(f"reserved subframe type {sf_type}")

    if wasted:
        out <<= wasted
    return out


def read_flac(path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (samples (n, channels) float32 in [-1,1], rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise FlacError(f"not a FLAC file: {path}")

    # ---- metadata blocks ----
    pos = 4
    streaminfo = None
    while True:
        header = data[pos]
        is_last = header >> 7
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        if btype == 0:
            streaminfo = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if is_last:
            break
    if streaminfo is None:
        raise FlacError("missing STREAMINFO")

    si = _BitReader(streaminfo)
    si.read(16)  # min block size
    si.read(16)  # max block size
    si.read(24)  # min frame size
    si.read(24)  # max frame size
    sample_rate = si.read(20)
    channels = si.read(3) + 1
    bps_stream = si.read(5) + 1
    total_samples = si.read(36)

    # ---- frames ----
    br = _BitReader(data, pos)
    chans = [[] for _ in range(channels)]
    decoded = 0
    total_bits = len(data) * 8
    while br.pos + 16 <= total_bits and (total_samples == 0 or decoded < total_samples):
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise FlacError(f"lost frame sync at bit {br.pos - 14}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_assign = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_number()

        if bs_code == 0:
            raise FlacError("reserved block size code 0")
        elif bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZE_CODES[bs_code]

        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)

        bps = _SAMPLE_SIZE_CODES.get(ss_code, bps_stream)
        br.read(8)  # CRC-8 (not verified)

        if chan_assign < 8:
            n_ch = chan_assign + 1
            if n_ch != channels:
                raise FlacError("frame/stream channel mismatch")
            sub = [_decode_subframe(br, block_size, bps) for _ in range(n_ch)]
        elif chan_assign <= 10 and channels != 2:
            # stereo-decorrelated assignments imply exactly 2 channels; on a
            # mono stream the mixdown below would silently keep only sub[0]
            # (the C++ twin rejects identically)
            raise FlacError("frame/stream channel mismatch")
        elif chan_assign == 8:  # left/side
            left = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            sub = [left, left - side]
        elif chan_assign == 9:  # right/side
            side = _decode_subframe(br, block_size, bps + 1)
            right = _decode_subframe(br, block_size, bps)
            sub = [right + side, right]
        elif chan_assign == 10:  # mid/side
            mid = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            left = ((mid << 1) | (side & 1)) + side
            sub = [left >> 1, (left - (side << 1)) >> 1]
        else:
            raise FlacError(f"reserved channel assignment {chan_assign}")

        br.align()
        br.read(16)  # CRC-16 (not verified)

        for c in range(channels):
            chans[c].append(sub[c])
        decoded += block_size

    out = np.stack([np.concatenate(c) for c in chans], axis=1)
    if total_samples:
        out = out[:total_samples]
    scale = float(1 << (bps_stream - 1))
    return (out.astype(np.float32) / scale), sample_rate
