"""The port's layer spans (``utils/profiling.span``) on the CPU: with no
profiler a span is one shared ``nullcontext``; under ``torch.profiler``
each hot path opens its ``atk/`` ranges, as many and in the order its
layers run: a served batch (the copy, the tokenizer, the classifier), a
training step and the ensemble's step (forward, backward, optimizer), a
device epoch (its order and its read) and a K-means fit (each Lloyd
iteration's assignment, sums and update, the objective at both ends);
``tools/span_report`` charges a trace's device time and idle gaps to
them."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.export import ServingProgram
from audio_tokens_tpu_torch.ops.kmeans import (kmeans_fit,
                                               kmeans_fit_streaming)
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.tools import span_report
from audio_tokens_tpu_torch.train.device_epoch import DeviceEpochRunner
from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer
from audio_tokens_tpu_torch.train.trainer import Trainer
from audio_tokens_tpu_torch.utils import profiling
from audio_tokens_tpu_torch.utils.profiling import span

VOCAB, C, T, B = 16, 5, 12, 4
STEP = ["atk/train.forward", "atk/train.backward", "atk/train.optimizer"]


def _cfg(tmp_path, **kw):
    return AudioTokensConfig(**{
        "base_dir": str(tmp_path), "model_type": "simple",
        "vocab_size": VOCAB, "num_classes": C, "max_seq_len": T,
        "training_batch_size": B, "hidden_size": 8, "random_seed": 3,
        "save_best_checkpoint": False, "log_every_steps": 0,
        "clip_seconds": 0.25, **kw})


def _ranges(prof, enclosing: str = None) -> list:
    """The ``atk/`` ranges the session recorded, in the order they opened;
    with ``enclosing``, only those inside one of its ranges."""
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    outer = [e.time_range for e in events if e.name == enclosing]
    return [e.name for e in events if e.name.startswith("atk/")
            and (enclosing is None or any(
                o.start <= e.time_range.start <= e.time_range.end <= o.end
                for o in outer))]


def _corpus(rng, n):
    return (rng.integers(0, VOCAB, (n, T)).astype(np.uint16),
            np.full(n, T, np.int32),
            (rng.random((n, C)) < 0.4).astype(np.uint8))


def test_span_without_a_profiler_is_one_nullcontext():
    assert span("serve.h2d") is span("lloyd.sums") is profiling._NO_SPAN
    with span("train.forward") as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("serve.h2d") is not profiling._NO_SPAN
    assert span("serve.h2d") is profiling._NO_SPAN


@pytest.mark.parametrize("model_type", ["simple", "lstm"])
def test_served_batch_spans(tmp_path, model_type):
    """The copy, the tokenizer and the classifier once each, in that order,
    inside the caller's range; the answers equal those served untraced."""
    cfg = _cfg(tmp_path, model_type=model_type, lstm_embed_dim=4,
               lstm_hidden_dim=6, num_layers=1)
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((VOCAB, cfg.n_mels)).astype(np.float32)
    prog = ServingProgram.from_components(
        cfg, FusedTokenizer(cfg, cents, "cpu"), device="cpu")
    waves = [rng.standard_normal(n).astype(np.float32)
             for n in (cfg.clip_samples, cfg.clip_samples // 2)]
    batch, lengths = prog.tokenizer.frontend.prepare_batch(waves)
    batch, lengths = torch.from_numpy(batch), torch.from_numpy(lengths)
    want = prog.serve(batch, lengths)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("request"):
            got = prog.serve(batch, lengths)
    assert _ranges(prof, "request") == _ranges(prof) == [
        "atk/serve.h2d", "atk/serve.tokenize", "atk/serve.classify"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_train_step_spans(tmp_path):
    trainer = Trainer(_cfg(tmp_path), "cpu")
    x = torch.randint(0, VOCAB, (B, T))
    y = torch.from_numpy(_corpus(np.random.default_rng(1), B)[2]).float()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer._train_step(x, torch.full((B,), T), y, torch.ones(B), 0)
    assert _ranges(prof) == STEP


def test_device_epoch_spans(tmp_path):
    """An epoch of 3 steps: its order, each step's three spans, its read."""
    trainer = Trainer(_cfg(tmp_path), "cpu")
    runner = DeviceEpochRunner(trainer)
    runner.set_corpus_arrays("train", *_corpus(np.random.default_rng(2),
                                               3 * B), 3 * B, B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert runner.train_epoch(0, 0)[0] == 3
    assert _ranges(prof) == ["atk/epoch.order"] + 3 * STEP + [
        "atk/epoch.read"]


def test_ensemble_step_spans(tmp_path):
    ens = EnsembleTrainer(_cfg(tmp_path), "cpu", n_models=2)
    ens.set_corpus_arrays("train", *_corpus(np.random.default_rng(3),
                                            2 * B), n_real=2 * B,
                          batch_size=B)
    params, opt_state = ens.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ens.train_epoch(params, opt_state, 0, 0)
    assert _ranges(prof) == 2 * STEP


@pytest.mark.parametrize("empty_policy", ["keep", "split_largest"])
def test_lloyd_spans(empty_policy):
    """``niter`` 3: each iteration's assignment, sums and update, the
    objective's sum of squares before them and its read after."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (200, 6)).astype(np.float32))
    want = kmeans_fit(x, 8, 3, empty_policy=empty_policy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = kmeans_fit(x, 8, 3, empty_policy=empty_policy)
    iteration = ["atk/lloyd.assign", "atk/lloyd.sums", "atk/lloyd.update"]
    assert _ranges(prof) == (["atk/kmeans.objective"] + 3 * iteration
                             + ["atk/kmeans.objective"])
    assert torch.equal(got[0], want[0]) and got[1] == want[1]


def test_streaming_lloyd_spans():
    """Two super-batches a pass: each one's assignment and sums (and, in
    the first pass, its sum of squares), then the iteration's objective
    read and update."""
    x = np.random.default_rng(5).standard_normal((200, 6)).astype(
        np.float32)

    def fit():
        return kmeans_fit_streaming(lambda: iter([x[:120], x[120:]]), 8, 2,
                                    d=6, superbatch_rows=128, chunk=64,
                                    device="cpu")

    want = fit()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fit()
    feed = ["atk/lloyd.assign", "atk/lloyd.sums"]
    end = ["atk/kmeans.objective", "atk/lloyd.update"]
    assert _ranges(prof) == (2 * (feed + ["atk/kmeans.objective"]) + end
                             + 2 * feed + end)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


def _step_events(spans: bool) -> list:
    """A training step inside a window: the forward's kernel launched from
    the main thread, the backward's from autograd's thread (tid 2) while
    the main thread is inside ``atk/train.backward``, and an HtoD copy;
    with ``spans``, the program's spans around them."""
    ev = [
        {"ph": "X", "name": "perfbench/window", "ts": 0, "dur": 100,
         "cat": "user_annotation", "tid": 1},
        {"ph": "X", "name": "perfbench/train_step", "ts": 0, "dur": 90,
         "cat": "user_annotation", "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "cat": "cuda_runtime", "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "name": "void fwd<1>(int)", "ts": 10, "dur": 20,
         "cat": "kernel", "args": {"correlation": 1}},
        {"ph": "X", "name": "cudaLaunchKernel", "ts": 31, "dur": 1,
         "cat": "cuda_runtime", "tid": 2, "args": {"correlation": 2}},
        {"ph": "X", "name": "void bwd<1>(int)", "ts": 35, "dur": 40,
         "cat": "kernel", "args": {"correlation": 2}},
        {"ph": "X", "name": "cudaMemcpyAsync", "ts": 80, "dur": 15,
         "cat": "cuda_runtime", "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 92,
         "dur": 4, "cat": "gpu_memcpy", "args": {"correlation": 3}},
    ]
    if spans:
        ev += [
            {"ph": "X", "name": "atk/train.forward", "ts": 2, "dur": 26,
             "cat": "user_annotation", "tid": 1},
            {"ph": "X", "name": "atk/train.backward", "ts": 30, "dur": 48,
             "cat": "user_annotation", "tid": 1},
            # the profiler's device-side copy of a range: not a host span
            {"ph": "X", "name": "atk/train.backward", "ts": 35, "dur": 40,
             "cat": "gpu_user_annotation"},
            {"ph": "X", "name": "atk/serve.h2d", "ts": 79, "dur": 17,
             "cat": "user_annotation", "tid": 1},
        ]
    return ev


def test_span_report_charges_launches_on_any_thread():
    """A device operation belongs to the innermost span that held its
    launch, on any thread; a span's ms are its operations' union over its
    instances, beside its own host ms."""
    rep = span_report.report(_step_events(True), "perfbench/window")
    assert rep["window_s"] == pytest.approx(100e-6)
    assert rep["busy_s"] == pytest.approx(64e-6)
    assert rep["charged_pct"] == pytest.approx(100.0)
    got = {k: (round(v["device_ms"], 9), round(v["host_ms"], 9),
               v["instances"]) for k, v in rep["spans"].items()}
    assert got == {"train.forward": (0.02, 0.026, 1),
                   "train.backward": (0.04, 0.048, 1),
                   "serve.h2d": (0.004, 0.017, 1)}
    plain = span_report.report(_step_events(False), "perfbench/window")
    assert plain["busy_s"] == rep["busy_s"]
    assert plain["spans"] == {} and plain["charged_pct"] == 0.0


def test_span_report_names_gaps():
    """A gap is named by the other range, then the program span, then the
    runtime call that held its midpoint."""
    def gaps(events):
        return [(n, round(ms * 1e3, 6)) for n, ms in span_report.report(
            events, "perfbench/window")["idle_gaps_ms"]]

    outer = "perfbench/train_step"
    assert gaps(_step_events(True)) == [
        (outer + "/serve.h2d:cudaMemcpyAsync", 17),
        (outer + "/train.forward:cudaLaunchKernel", 10),
        (outer + "/train.backward", 5), ("host", 4)]
    assert gaps(_step_events(False)) == [
        (outer + ":cudaMemcpyAsync", 17), (outer + ":cudaLaunchKernel", 10),
        (outer, 5), ("host", 4)]


def test_span_report_reads_a_stage_trace(tmp_path, capsys):
    """A served batch traced by ``maybe_trace`` on the CPU: the report
    finds its three spans once each, with host time and no device time."""
    cfg = _cfg(tmp_path)
    rng = np.random.default_rng(6)
    cents = rng.standard_normal((VOCAB, cfg.n_mels)).astype(np.float32)
    prog = ServingProgram.from_components(
        cfg, FusedTokenizer(cfg, cents, "cpu"), device="cpu")
    batch, lengths = prog.tokenizer.frontend.prepare_batch(
        [rng.standard_normal(cfg.clip_samples).astype(np.float32)])
    with profiling.maybe_trace(str(tmp_path / "traces"), "cpu"):
        prog.serve(torch.from_numpy(batch), torch.from_numpy(lengths))
    (trace,) = (tmp_path / "traces").iterdir()
    assert span_report.main([str(trace)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert list(rep["spans"]) == ["serve.classify", "serve.h2d",
                                  "serve.tokenize"]
    for row in rep["spans"].values():
        assert row["instances"] == 1 and row["host_ms"] > 0
        assert row["device_ms"] == 0
    assert rep["busy_s"] == 0 and rep["charged_pct"] is None
