"""A run with the timed path broken underneath must come out not correct:
each fault that a cell can have, planted in the program, at a tiny size on
the CPU (the look for a card skipped, the rest of a run driven).  A cell
on one card has no exchange between cards to leave out, and serving keeps
no state for a step to leave unchanged."""

from __future__ import annotations

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

CPU = torch.device("cpu")


def run_tiny(name: str) -> dict:
    return run.run_cell(tiny.cell(name), 2**31 + 5, 0.2, False, CPU)


def _serve_token(monkeypatch):
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    real = FusedTokenizer._tokens_dispatch

    def altered(self, *a, **k):
        tokens = real(self, *a, **k).clone()
        tokens[0, 0] = (tokens[0, 0] + 1) % self.centroids.shape[0]
        return tokens

    monkeypatch.setattr(FusedTokenizer, "_tokens_dispatch", altered)


def _serve_half(monkeypatch):
    from audio_tokens_tpu_torch.export import ServingModule

    real = ServingModule.forward

    def half(self, *a):
        tokens, n_valid, probs = real(self, *a)
        probs = probs.clone()
        probs[probs.shape[0] // 2:] = 0.0  # half of the answers left out
        return tokens, n_valid, probs

    monkeypatch.setattr(ServingModule, "forward", half)


def _serve_answer(monkeypatch):
    from audio_tokens_tpu_torch.export import ServingModule

    real = ServingModule.forward

    def altered(self, *a):
        tokens, n_valid, probs = real(self, *a)
        probs = probs.clone()
        probs[0, 0] = 1.0 - probs[0, 0]
        return tokens, n_valid, probs

    monkeypatch.setattr(ServingModule, "forward", altered)


def _train_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _train_half(monkeypatch):
    from audio_tokens_tpu_torch.train import trainer

    real = trainer.weighted_bce

    def half(logits, labels, row_w, denom=None):
        row_w = row_w.clone()
        row_w[row_w.shape[0] // 2:] = 0.0  # the mean over the rest
        return real(logits, labels, row_w, denom)

    monkeypatch.setattr(trainer, "weighted_bce", half)


def _train_answer(monkeypatch):
    from audio_tokens_tpu_torch.train.trainer import Trainer

    real = Trainer._logits

    def altered(self, *a, **k):
        out = real(self, *a, **k).clone()
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(Trainer, "_logits", altered)


def _cluster_unchanged(monkeypatch):
    from audio_tokens_tpu_torch.ops import kmeans

    monkeypatch.setattr(kmeans, "_update", lambda c, s, n, policy: c)


def _cluster_half(monkeypatch):
    from audio_tokens_tpu_torch.ops import kmeans

    real = kmeans._lloyd_stats

    def half(x, centroids, tier="highest"):
        sums, counts, score = real(x[:x.shape[0] // 2], centroids, tier)
        return sums, counts, score

    monkeypatch.setattr(kmeans, "_lloyd_stats", half)


def _cluster_answer(monkeypatch):
    """A fit's answer, its centroid table, altered where it is made."""
    from audio_tokens_tpu_torch.ops import kmeans

    real = kmeans._update

    def altered(*a):
        return real(*a) * 1.001

    monkeypatch.setattr(kmeans, "_update", altered)


FAULTS = [
    ("lstm_k500.serve_b64", _serve_token), ("lstm_k500.serve_b64", _serve_half),
    ("lstm_k500.serve_b64", _serve_answer),
    ("bert_k500.serve_b64", _serve_token), ("bert_k500.serve_b64", _serve_half),
    ("bert_k500.serve_b64", _serve_answer),
    ("lstm_k500.train_b64", _train_unchanged),
    ("lstm_k500.train_b64", _train_half),
    ("lstm_k500.train_b64", _train_answer),
    ("lstm_k500.cluster_17m", _cluster_unchanged),
    ("lstm_k500.cluster_17m", _cluster_half),
    ("lstm_k500.cluster_17m", _cluster_answer),
]


@pytest.mark.parametrize("name,plant", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, plant):
    plant(monkeypatch)
    result = run_tiny(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted({n for n, _ in FAULTS}))
def test_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["checks"]
