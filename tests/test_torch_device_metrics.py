"""The port's on-device macro mAP (``utils/device_metrics.py``) against the
JAX package's (``audio_tokens_tpu/utils/device_metrics.py``) and the host
metrics, on the CPU: the exact metric within 1e-6 with continuous and tied
scores (quantized, saturated), a class without positives and padded rows;
the binned metric's histogram equal count for count to the JAX one and to
the port's host ``StreamingMAP``, its result within 1e-6 of both.  Mirrors
JAX ``tests/test_device_epoch.py``'s metric tests."""

import numpy as np
import pytest
import torch

from audio_tokens_tpu.utils import device_metrics as jax_dm
from audio_tokens_tpu_torch.utils.device_metrics import (
    binned_map_init, binned_map_result, binned_map_update, macro_map_device)
from audio_tokens_tpu_torch.utils.metrics import (
    StreamingMAP, macro_mean_average_precision)


def _scores(rng, n, c, quantize=0):
    scores = rng.random((n, c)).astype(np.float32)
    if quantize:
        scores = np.round(scores * quantize) / quantize  # heavy ties
    return scores


@pytest.mark.parametrize("quantize", [0, 4, 1])  # 0 = continuous, else ties
def test_macro_map_device_matches_jax_and_numpy(rng, quantize):
    n, c = 120, 9
    scores = _scores(rng, n, c, quantize)
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    labels[:, -1] = 0.0  # a class without positives: excluded
    valid = np.ones(n, bool)
    valid[100:] = False  # padded tail rows: excluded exactly
    got = float(macro_map_device(torch.from_numpy(scores),
                                 torch.from_numpy(labels.astype(np.uint8)),
                                 torch.from_numpy(valid)))
    assert got == pytest.approx(
        float(jax_dm.macro_map_device(scores, labels, valid)), abs=1e-6)
    assert got == pytest.approx(
        macro_mean_average_precision(labels[:100], scores[:100]), abs=1e-6)


def test_macro_map_device_no_positives(rng):
    scores = torch.from_numpy(_scores(rng, 16, 3))
    got = macro_map_device(scores, torch.zeros((16, 3)),
                           torch.ones(16, dtype=torch.bool))
    assert got.dtype == torch.float32 and float(got) == 0.0


def test_macro_map_device_saturated_ties(rng):
    """Saturated sigmoids (runs of exact 0.0 / 1.0), the ties trained
    models hit."""
    n, c = 64, 5
    scores = rng.choice([0.0, 0.25, 1.0], size=(n, c)).astype(np.float32)
    labels = (rng.random((n, c)) < 0.4).astype(np.float32)
    valid = np.ones(n, bool)
    got = float(macro_map_device(torch.from_numpy(scores),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(valid)))
    assert got == pytest.approx(
        float(jax_dm.macro_map_device(scores, labels, valid)), abs=1e-6)
    assert got == pytest.approx(macro_mean_average_precision(labels, scores),
                                abs=1e-6)


@pytest.mark.parametrize("bins", [512, 8192])
def test_binned_map_equals_jax_and_host_streaming(rng, bins):
    """Batched updates as the epoch makes them, padded rows masked: the
    (2, C, bins) counts equal the JAX histogram's and the host
    ``StreamingMAP``'s, and the result agrees with both (f32 vs f64)."""
    n, c = 200, 9
    scores = _scores(rng, n, c)
    scores[:20] = np.round(scores[:20] * 4) / 4  # saturated, tied buckets
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    labels[:, -1] = 0.0
    valid = np.ones(n, bool)
    valid[180:] = False
    hist = binned_map_init(c, bins, "cpu")
    jhist = jax_dm.binned_map_init(c, bins)
    for lo in range(0, n, 32):
        sl = slice(lo, lo + 32)
        binned_map_update(hist, torch.from_numpy(scores[sl]),
                          torch.from_numpy(labels[sl].astype(np.uint8)),
                          torch.from_numpy(valid[sl]).float())
        jhist = jax_dm.binned_map_update(jhist, scores[sl], labels[sl],
                                         valid[sl])
    host = StreamingMAP(c, bins=bins)
    host.update(labels[:180], scores[:180])
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(hist[0].numpy(), host.pos)
    np.testing.assert_array_equal(hist[1].numpy(), host.neg)
    got = float(binned_map_result(hist))
    assert got == pytest.approx(float(jax_dm.binned_map_result(jhist)),
                                abs=1e-6)
    assert got == pytest.approx(host.result()["mAP"], abs=1e-6)


def test_binned_map_close_to_exact(rng):
    """At a real bin count the histogram metric tracks the exact one well
    within the binning error (~1/bins)."""
    n, c, bins = 400, 7, 8192
    scores = torch.from_numpy(_scores(rng, n, c))
    labels = torch.from_numpy((rng.random((n, c)) < 0.2).astype(np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    hist = binned_map_update(binned_map_init(c, bins, "cpu"), scores, labels,
                             valid)
    assert float(binned_map_result(hist)) == pytest.approx(
        float(macro_map_device(scores, labels, valid)), abs=2e-3)
