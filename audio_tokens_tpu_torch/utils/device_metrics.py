"""Macro mAP on the device (counterpart of
``audio_tokens_tpu/utils/device_metrics.py``).

The streaming Trainer copies every batch's sigmoids to the host and
computes mAP there (``utils/metrics.py``).  The device-resident epochs
(``train/device_epoch.py``) keep the epoch's predictions on the card and
evaluate the metric there, so an epoch's card -> host traffic is two
scalars.  Plain tensor functions: the JAX package computes them outside any
Pallas kernel, and so does the port.

``macro_map_device`` has ``utils.metrics.binary_average_precision``'s
threshold semantics (every run of equal scores is one threshold group,
precision taken at the group's end), accumulated in float32: the
cumulative true-positive counts are integers, exact in f32 up to 2^24 rows.
The binned metric is the device twin of ``utils.metrics.StreamingMAP``: a
(2, C, bins) int32 histogram of (positive, negative) counts a bucket, in
constant memory whatever the corpus size.
"""

from __future__ import annotations

import torch


def macro_map_device(scores: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Macro mean average precision over the classes with a positive.

    scores (N, C) in [0, 1]; labels (N, C) {0, 1} of any dtype; valid (N,)
    bool marks the real rows (padding rows are excluded exactly).  Returns
    a 0-dim f32 tensor on the scores' device, 0 when no class has a
    positive (as ``utils.metrics.macro_mean_average_precision``).
    """
    n = scores.shape[0]
    keep = valid.bool()[:, None]
    # invalid rows: score -1 sorts them after every sigmoid and label 0 makes
    # them a trailing threshold group without positives, which adds nothing
    s = torch.where(keep, scores.float(), -1.0).t()           # (C, N)
    y = (keep & (labels > 0.5)).t().float()                   # (C, N)
    s_sorted, order = torch.sort(s, dim=1, descending=True, stable=True)
    y_sorted = torch.gather(y, 1, order)
    tps = torch.cumsum(y_sorted, dim=1)
    n_pos = tps[:, -1]
    # AP = (1 / n_pos) sum_i y_i precision[group_end(i)], group_end(i) =
    # the last index of i's run of equal scores, by a reversed cumulative min
    is_last = torch.ones_like(s_sorted, dtype=torch.bool)
    is_last[:, :-1] = s_sorted[:, 1:] != s_sorted[:, :-1]
    idx = torch.arange(n, device=s.device)
    cand = torch.where(is_last, idx[None, :], n - 1)
    group_end = torch.cummin(cand.flip(1), dim=1).values.flip(1)
    prec_end = torch.gather(tps, 1, group_end) / (group_end.float() + 1.0)
    ap = (y_sorted * prec_end).sum(1) / torch.clamp(n_pos, min=1.0)
    has_pos = n_pos > 0
    mean = (ap * has_pos).sum() / torch.clamp(has_pos.sum(), min=1)
    return torch.where(has_pos.any(), mean, torch.zeros_like(mean))


def binned_map_init(num_classes: int, bins: int,
                    device: torch.device | str) -> torch.Tensor:
    """The zero histogram: (2, C, bins) int32, [0] positives, [1] negatives."""
    return torch.zeros((2, num_classes, bins), dtype=torch.int32,
                       device=device)


def binned_map_update(hist: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """Add one batch to ``hist`` in place and return it.  scores (B, C) in
    [0, 1]; labels (B, C) {0, 1}; valid (B,) bool or float: invalid
    (padding) rows add nothing."""
    _, c, bins = hist.shape
    idx = torch.clamp((scores.float() * bins).to(torch.int64), 0, bins - 1)
    pol = torch.where(labels > 0.5, 0, 1)
    flat = (pol * c + torch.arange(c, device=idx.device)[None, :]) * bins + idx
    add = (valid > 0).to(torch.int32)[:, None].expand(idx.shape)
    hist.view(-1).index_add_(0, flat.reshape(-1), add.reshape(-1))
    return hist


def binned_map_result(hist: torch.Tensor) -> torch.Tensor:
    """Macro mAP from the histogram over the classes with a positive: the
    buckets walked from high scores to low, each a threshold (empty ones add
    no recall, as in the host ``StreamingMAP``).  0-dim f32."""
    pos = hist[0].flip(1).float()
    neg = hist[1].flip(1).float()
    tps = torch.cumsum(pos, dim=1)
    fps = torch.cumsum(neg, dim=1)
    n_pos = tps[:, -1]
    has_pos = n_pos > 0
    precision = tps / torch.clamp(tps + fps, min=1.0)
    recall = tps / torch.clamp(n_pos[:, None], min=1.0)
    delta_r = torch.diff(recall, dim=1, prepend=torch.zeros_like(recall[:, :1]))
    aps = (delta_r * precision).sum(1)
    mean = (aps * has_pos).sum() / torch.clamp(has_pos.sum(), min=1)
    return torch.where(has_pos.any(), mean, torch.zeros_like(mean))
