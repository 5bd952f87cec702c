"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import json

import pytest

from perfbench import peaks, readers, registry, work
from perfbench.tracing import Trace

CFG = {c["name"]: json.loads((registry.ROOT / c["file"]).read_text())
       for c in registry.load_benchmark()["configs"]}
LSTM, BERT = CFG["lstm_k500"], CFG["bert_k500"]


def test_lstm_step_is_2_09_tflop():
    """Batch 64, T 1728, E 256, H 512, both directions: 3 x (E 4H + H 4H)
    x 2 x 2 operations a token, plus the head's."""
    parts = work.train_step(LSTM, {"batch": 64})
    ops = sum(p.ops for p in parts)
    by_hand = 3 * 2 * 2 * (256 * 2048 + 512 * 2048) * 64 * 1728
    head = 3 * 2 * 64 * 1024 * 543
    assert ops == pytest.approx(by_hand + head)
    assert ops / 1e12 == pytest.approx(2.09, abs=0.005)


def test_b3_b4_at_the_table_s_bounds():
    b3 = peaks.least_seconds(work.b3(LSTM, {"batch": 64}))
    b4 = peaks.least_seconds(work.b4(LSTM, {"batch": 64}))
    assert b3 * 1e3 == pytest.approx(6.923, abs=0.002)  # 464 GFLOP f32
    assert b4 == pytest.approx(2 * b3)


def test_b5_needed_work_by_prefix_lengths():
    """A row of length L attends L^2 + (T - L)^2 pairs (its two
    segments); no lengths is T^2; 4 dh operations a pair and head."""
    t, heads, dh, layers = 512, 12, 64, 1
    lengths = [512, 256, 0, 100]
    pairs = sum(n * n + (t - n) ** 2 for n in lengths)
    (part,) = work.flash_attention(BERT, 4, lengths)
    assert part.dtype == "float32"
    assert part.nbytes == 4.0 * 4 * heads * t * dh * 4 * layers
    assert part.ops == 4.0 * pairs * heads * dh * layers
    (full,) = work.flash_attention(BERT, 4)
    assert full.ops == 4.0 * 4 * t * t * heads * dh * layers
    with pytest.raises(ValueError):
        work.flash_attention(BERT, 3, lengths)


def test_b1_and_b2():
    (b1,) = work.b1(LSTM, {"batch": 64})
    frames = 64 * 1723
    assert b1.ops == 2.0 * frames * (512 * 512 + 256 * 64 + 64 * 500)
    assert b1.ops / 1e9 == pytest.approx(68.5, abs=0.1)
    mix = {"clips": 10000, "frames_per_clip": 1723, "niter": 20}
    (b2,) = work.b2(LSTM, mix)
    assert b2.ops == 20 * 2.0 * 17_230_000 * 500 * 64
    assert peaks.least_seconds(work.b2(LSTM, dict(mix, niter=1))) * 1e3 == (
        pytest.approx(16.459, abs=0.01))


def test_least_time_takes_the_larger_bound():
    p = peaks.Part("float32", 67e12, 3.35e12 * 2)
    assert p.least_seconds() == 2.0
    assert peaks.least_seconds([p, peaks.Part("bfloat16", 989e12)]) == 3.0


def test_readers_share_and_silence():
    tr = Trace(window_s=1.0, busy_s=0.5,
               kernels={"void lstm_fwd_kernel<1>(x)": 0.02})
    ctx = readers.Context(LSTM, {"batch": 64}, 2, tr)
    share = readers.roofline({"kernels": ["lstm_fwd_kernel"], "work": "b3"},
                             ctx)
    assert share == pytest.approx(100 * 2 * 6.923e-3 / 0.02, rel=1e-3)
    assert readers.roofline({"kernels": ["absent"], "work": "b3"}, ctx) is None
    assert readers.idle_share({}, ctx) == 50.0
    empty = readers.Context(LSTM, {"batch": 64}, 2, Trace(1.0, 0.0))
    assert readers.idle_share({}, empty) is None
    assert readers.mfu({"work": "b3"}, empty) is None
