"""Needed work of each kernel and of each whole unit (a served batch, a
training step, a K-means fit), from the configuration's sizes and the
traffic's shapes.

"Needed" is what the algorithm as specified must do for these inputs, not
what a kernel happens to do: every input byte read once, every output byte
written once, and the products the math calls for.  The DFT is the
reference's DFT by matmul (bins 0..n_fft/2-1: the Nyquist bin's filterbank
row is zero), the lstm's products are the gate products of both directions,
attention counts the (query, key) pairs that the segment masks leave, and
the K-means sums need one read of the points and their ids.

Each function takes the configuration (``configs/<name>.json`` as a dict)
and the traffic's parameters (``traffic/<mix>.json``) and returns a list of
``peaks.Part``: one per arithmetic type, so that ``peaks.least_seconds``
puts each at its own peak.  Copied from ``chip_smoke.py`` (``bound_of``,
the B1-B5 bounds) and ``tools/bench_training.py`` (``_train_flops``), and
corrected for the masks and for bytes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from perfbench.peaks import Part

F32 = 4


def clip_samples(cfg: dict) -> int:
    return int(cfg["common_sr"] * cfg["clip_seconds"])


def frames_per_clip(cfg: dict) -> int:
    """Centered frames of a full clip: 1 + samples // hop."""
    return 1 + clip_samples(cfg) // cfg["hop_length"]


def padded_len(cfg: dict) -> int:
    """Samples of a served row: the clip with n_fft / 2 of reflection on
    each side."""
    return clip_samples(cfg) + cfg["n_fft"]


# -- kernels ------------------------------------------------------------------
def tokenize(cfg: dict, batch: int) -> List[Part]:
    """B1: waveform rows -> token ids, f32: the windowed DFT by matmul, the
    power's mel product and the distances to every centroid."""
    f = batch * frames_per_clip(cfg)
    n_fft, m, k = cfg["n_fft"], cfg["n_mels"], cfg["vocab_size"]
    nb = n_fft // 2
    ops = 2.0 * f * (n_fft * 2 * nb + nb * m + m * k)
    nbytes = F32 * (batch * padded_len(cfg) + f + n_fft * 2 * nb + nb * m
                    + k * m)
    return [Part("float32", ops, nbytes)]


def lstm_recurrence(cfg: dict, batch: int, steps: int) -> Part:
    """One direction's recurrence (B3's work, or B4's, or ``dw_hh``'s):
    the (B, H) x (H, 4H) product every step; the gate inputs read and the
    hidden states written."""
    h = cfg["lstm_hidden_dim"]
    ops = 2.0 * steps * batch * h * 4 * h
    nbytes = F32 * (steps * batch * 4 * h + steps * batch * h + h * 4 * h)
    return Part("float32", ops, nbytes)


def _directions(part: Part, n: int) -> Part:
    return Part(part.dtype, part.ops * n, part.nbytes * n)


def lstm_forward(cfg: dict, batch: int) -> List[Part]:
    """B3, both directions of every layer."""
    rec = lstm_recurrence(cfg, batch, cfg["max_seq_len"])
    return [_directions(rec, 2 * cfg["num_layers"])]


def lstm_backward(cfg: dict, batch: int) -> List[Part]:
    """B4's recurrence and ``dw_hh``, both directions of every layer: two
    products of the forward's size."""
    rec = lstm_recurrence(cfg, batch, cfg["max_seq_len"])
    return [_directions(rec, 4 * cfg["num_layers"])]


def attention_pairs(t: int, lengths: Optional[Sequence[int]],
                    batch: int) -> float:
    """(query, key) pairs over a batch under B5's segment masks: a row of
    length L puts positions below L in one segment and the rest in another,
    and a position attends within its own segment; no lengths is one
    segment of T."""
    if lengths is None:
        return float(batch) * t * t
    if len(lengths) != batch:
        raise ValueError(f"{len(lengths)} lengths for a batch of {batch}")
    return float(sum(min(n, t) ** 2 + (t - min(n, t)) ** 2 for n in lengths))


def flash_attention(cfg: dict, batch: int,
                    lengths: Optional[Sequence[int]] = None) -> List[Part]:
    """B5's forward in every layer: scores and the weighted sum (4 dh
    operations a pair and head) in the compute type; q, k, v read and the
    output written."""
    hidden, t = cfg["hidden_size"], cfg["transformer_max_position"]
    heads, dh = hidden // 64, 64
    dtype = cfg["compute_dtype"]
    size = 2 if dtype in ("bfloat16", "float16") else F32
    pairs = attention_pairs(t, lengths, batch)
    ops = 4.0 * pairs * heads * dh * cfg["num_layers"]
    nbytes = 4.0 * batch * heads * t * dh * size * cfg["num_layers"]
    return [Part(dtype, ops, nbytes)]


def assign(cfg: dict, rows: int) -> List[Part]:
    """B2 at ``normalize=False``, f32: ||c||^2 - 2 x.c for every row and
    centroid; the rows read and their ids written."""
    d, k = cfg["n_mels"], cfg["vocab_size"]
    return [Part("float32", 2.0 * rows * k * d,
                 F32 * (rows * d + rows + k * d))]


def cluster_sums(cfg: dict, rows: int) -> List[Part]:
    """The centroid sums, the sort of the ids included: the rows and their
    ids read once, the (K, d) f64 sums written."""
    d, k = cfg["n_mels"], cfg["vocab_size"]
    return [Part("float64", float(rows * d), F32 * (rows * d + rows)
                 + 8.0 * k * d)]


# -- whole units ---------------------------------------------------------------
def classifier_forward(cfg: dict, batch: int) -> List[Part]:
    """The classifier's forward on (batch, max_seq_len) tokens, in eval
    mode: its products (the embedding is a gather)."""
    t, c = cfg["max_seq_len"], cfg["num_classes"]
    if cfg["model_type"] == "lstm":
        e, h = cfg["lstm_embed_dim"], cfg["lstm_hidden_dim"]
        inputs = 0.0
        for layer in range(cfg["num_layers"]):
            width = e if layer == 0 else 2 * h
            inputs += 2 * 2.0 * batch * t * width * 4 * h
        fc = 2.0 * batch * 2 * h * c
        return ([Part("float32", inputs + fc, F32 * batch * t * e)]
                + lstm_forward(cfg, batch))
    if cfg["model_type"] == "bert":
        hidden, dtype = cfg["hidden_size"], cfg["compute_dtype"]
        t = min(t, cfg["transformer_max_position"])
        # q, k, v, out (4 H^2) and the MLP (8 H^2) a token and layer
        dense = 2.0 * 12 * hidden * hidden * batch * t * cfg["num_layers"]
        head = 2.0 * batch * hidden * c
        return ([Part(dtype, dense), Part("float32", head)]
                + flash_attention(cfg, batch))
    raise ValueError(f"no work function for model_type {cfg['model_type']}")


def serve_batch(cfg: dict, mix: dict) -> List[Part]:
    """A served batch: B1, then the classifier.  The host -> card copy is
    the link's work, not the device's, and is left out."""
    b = mix["batch"]
    return tokenize(cfg, b) + classifier_forward(cfg, b)


def n_params_lstm(cfg: dict) -> int:
    e, h = cfg["lstm_embed_dim"], cfg["lstm_hidden_dim"]
    n = cfg["vocab_size"] * e
    for layer in range(cfg["num_layers"]):
        width = e if layer == 0 else 2 * h
        n += 2 * (width * 4 * h + h * 4 * h + 4 * h)
    return n + 2 * h * cfg["num_classes"] + cfg["num_classes"]


def train_step(cfg: dict, mix: dict) -> List[Part]:
    """An lstm training step: the forward's products, their backward (the
    input-gate product's dx and dw, B4's recurrence and ``dw_hh``, the
    head's), and AdamW (read parameter, gradient and two moments, write
    parameter and moments: 28 bytes a parameter)."""
    if cfg["model_type"] != "lstm":
        raise ValueError("train_step counts the lstm only")
    b, t = mix["batch"], cfg["max_seq_len"]
    e, h, c = cfg["lstm_embed_dim"], cfg["lstm_hidden_dim"], cfg["num_classes"]
    gates = 0.0
    for layer in range(cfg["num_layers"]):
        width = e if layer == 0 else 2 * h
        gates += 3 * 2 * 2.0 * b * t * width * 4 * h  # forward, dx, dw
    head = 3 * 2.0 * b * 2 * h * c
    rec = lstm_forward(cfg, b)[0]
    bwd = lstm_backward(cfg, b)[0]
    adamw = Part("float32", 0.0, 7 * F32 * n_params_lstm(cfg))
    return [Part("float32", gates + head + rec.ops + bwd.ops), adamw]


def rows(mix: dict) -> int:
    """The clustering batch's frames."""
    return mix["clips"] * mix["frames_per_clip"]


def cluster_fit(cfg: dict, mix: dict) -> List[Part]:
    """One K-means fit of ``niter`` Lloyd iterations over the resident
    rows: each iteration's assignment and sums, and one read of the rows
    for sum ||x||^2."""
    n, niter = rows(mix), mix["niter"]
    it = assign(cfg, n) + cluster_sums(cfg, n)
    parts = [Part(p.dtype, p.ops * niter, p.nbytes * niter) for p in it]
    return parts + [Part("float32", 2.0 * n * cfg["n_mels"],
                         F32 * n * cfg["n_mels"])]


# -- per unit, by the names that metrics/<name>.json give ----------------------
def b1(cfg: dict, mix: dict) -> List[Part]:
    return tokenize(cfg, mix["batch"])


def b3(cfg: dict, mix: dict) -> List[Part]:
    return lstm_forward(cfg, mix["batch"])


def b4(cfg: dict, mix: dict) -> List[Part]:
    return lstm_backward(cfg, mix["batch"])


def b5(cfg: dict, mix: dict) -> List[Part]:
    # reference_compat: the served model attends over every position
    return flash_attention(cfg, mix["batch"])


def b2(cfg: dict, mix: dict) -> List[Part]:
    parts = assign(cfg, rows(mix))
    return [Part(p.dtype, p.ops * mix["niter"], p.nbytes * mix["niter"])
            for p in parts]


def sums(cfg: dict, mix: dict) -> List[Part]:
    parts = cluster_sums(cfg, rows(mix))
    return [Part(p.dtype, p.ops * mix["niter"], p.nbytes * mix["niter"])
            for p in parts]
