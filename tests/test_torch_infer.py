"""Serving from checkpoints: the port's ``Predictor``, ``ManualTester`` and
``ServingProgram(config)`` against the JAX package's, for a token (simple),
a spec (cnn) and a flat (baseline) family, on the CPU; then the infer CLI
and a staged ``run_pipeline.main`` run of the cnn.

Each side loads its own checkpoint of the same weights: seeded random JAX
parameters saved by the JAX ``train/checkpoint.save_checkpoint``, and the
same tree through ``convert.state_dict_for`` saved by the port's.  Both read
one centroids file (``output/centroids.npy``).  Tokens are compared under
the near-tie rule (``ops/vq.check_near_ties``); probabilities at
``PROBS_TOL``: the token family sees equal inputs (rtol 1e-5 / atol 1e-6,
as ``tests/test_torch_serving.py``), the spec and flat families see log-mel
frames that the two frontends sum in other orders (5e-3 dB apart at most,
``tests/test_torch_mel.py``), carried through a 3,264-wide (cnn) or
17,408-wide (baseline) first layer: rtol 2e-4 / atol 1e-5, the bound of
the JAX package's own spec-family serving test (``tests/test_export.py``).
The port's ``Predictor`` and ``ServingProgram`` compute one function and
agree to rtol 1e-5 / atol 1e-6."""

import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu.data.splitter import DatasetSplitter
from audio_tokens_tpu.export import ServingProgram as JaxServing
from audio_tokens_tpu.infer import ManualTester as JaxManualTester
from audio_tokens_tpu.infer import Predictor as JaxPredictor
from audio_tokens_tpu.models import get_model as jax_get_model
from audio_tokens_tpu.train.checkpoint import save_checkpoint as jax_save
from audio_tokens_tpu_torch import infer, run_pipeline
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import state_dict_for
from audio_tokens_tpu_torch.export import ServingProgram
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.train.checkpoint import save_checkpoint
from tests import fixtures
from tests.test_torch_families import randomize

REPO = Path(__file__).resolve().parents[1]
FAMILIES = {
    "simple": dict(model_type="simple"),
    "cnn": dict(model_type="cnn", dataset_type="RawSTFTDataset"),
    "baseline": dict(model_type="baseline",
                     dataset_type="RawSTFTFlatDataset"),
}
PROBS_TOL = {"simple": dict(rtol=1e-5, atol=1e-6),
             "cnn": dict(rtol=2e-4, atol=1e-5),
             "baseline": dict(rtol=2e-4, atol=1e-5)}
SAME_TOL = dict(rtol=1e-5, atol=1e-6)
# clips of 2.0-2.75 s and one of 3.5 s, longer than the 3 s window
WAVES = [fixtures.synth_clip(i) for i in (1, 2, 3)] + [
    fixtures.synth_clip(4, seconds=3.5)]


def _dummy_input(cfg, kind):
    t = cfg.max_seq_len
    if kind == "tokens":
        return jnp.zeros((1, t), jnp.int32)
    if kind == "spec":
        return jnp.zeros((1, t, cfg.n_mels), jnp.float32)
    return jnp.zeros((1, t * cfg.n_mels), jnp.float32)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The fixture workspace (24 wav clips, metadata), seeded unit
    centroids, and per family a JAX config and a port config whose
    checkpoints hold the same weights."""
    base = tmp_path_factory.mktemp("infer_ws")
    fixtures.make_workspace(base)
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((16, 32)).astype(np.float32)
    np.save(base / "output" / "centroids.npy",
            cents / np.linalg.norm(cents, axis=1, keepdims=True))
    out = {}
    for name, fam in FAMILIES.items():
        jcfg = fixtures.test_config(
            base, compute_dtype="float32",
            checkpoint_dir=str(base / "jax_ckpt" / name), **fam)
        pcfg = AudioTokensConfig(**{
            **jcfg.to_dict(), "checkpoint_dir": str(base / "ckpt" / name)})
        model = jax_get_model(jcfg)
        kind = {"simple": "tokens", "cnn": "spec", "baseline": "flat"}[name]
        params = randomize(model.init(jax.random.key(0),
                                      _dummy_input(jcfg, kind))["params"],
                           rng)
        jax_save(jcfg.checkpoint_dir, "no-wandb-best", params)
        pm = get_model(pcfg, "cpu", torch.Generator().manual_seed(0))
        pm.load_state_dict(state_dict_for(name, params))
        save_checkpoint(pcfg.checkpoint_dir, "no-wandb-best", pm)
        out[name] = (jcfg, pcfg)
    return base, out


def _check_tokens(tokenizer, waves, got, ref):
    """Per clip: equal lengths, ids equal up to near-ties."""
    batch, lengths = tokenizer.frontend.prepare_batch(waves)
    unit = l2_normalize(tokenizer.kernel.log_mel_plain(
        torch.from_numpy(batch)))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == np.int64 and len(g) == len(r)
        check_near_ties(unit[i, : len(g)], tokenizer.centroids,
                        torch.from_numpy(g), torch.from_numpy(np.array(r)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predictor_matches_jax(workspace, family):
    jcfg, pcfg = workspace[1][family]
    jpred = JaxPredictor(jcfg)
    pred = infer.Predictor(pcfg, device="cpu")
    assert pred.input_kind == jpred.input_kind
    got, ref = zip(*[(pred.predict_waveform(w), jpred.predict_waveform(w))
                     for w in WAVES])
    _check_tokens(pred.tokenizer, WAVES, [t for t, _ in got],
                  [t for t, _ in ref])
    probs = np.stack([p for _, p in got])
    assert probs.dtype == np.float32 and probs.shape == (len(WAVES), 7)
    np.testing.assert_allclose(probs, np.stack([p for _, p in ref]),
                               **PROBS_TOL[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_serving_program_from_checkpoint_matches_jax(workspace, family):
    jcfg, pcfg = workspace[1][family]
    jprog = JaxServing(jcfg, use_pallas=False)
    prog = ServingProgram(pcfg, device="cpu")
    assert prog.input_kind == jprog.input_kind
    batch, lengths = prog.tokenizer.frontend.prepare_batch(WAVES)
    lengths[-1] = len(WAVES[-1])  # past the window: clamped in the program
    ref = jprog(jnp.asarray(batch), jnp.asarray(lengths))
    tokens, n_valid, probs = prog(torch.from_numpy(batch),
                                  torch.from_numpy(lengths))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref[1]))
    _check_tokens(prog.tokenizer, WAVES,
                  [tokens[i, :n].numpy().astype(np.int64)
                   for i, n in enumerate(n_valid.tolist())],
                  [np.asarray(ref[0])[i, :n]
                   for i, n in enumerate(n_valid.tolist())])
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref[2]),
                               **PROBS_TOL[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predictor_equals_serving_program(workspace, family):
    """Two steps with the host between them, or one call: one answer."""
    _, pcfg = workspace[1][family]
    pred = infer.Predictor(pcfg, device="cpu")
    prog = ServingProgram(pcfg, device="cpu")
    toks, probs = prog.predict_waveforms(WAVES)
    for wave, t, p in zip(WAVES, toks, probs):
        p_tokens, p_probs = pred.predict_waveform(wave)
        np.testing.assert_array_equal(p_tokens, t)
        np.testing.assert_allclose(p_probs, p, **SAME_TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("normalize", [False, True])
def test_serving_program_routes_each_input_kind(workspace, family,
                                                normalize):
    """The model input of each kind, built as Predictor builds it: valid
    tokens zero-padded, or (normalized) mel frames copied into a zero
    buffer of max_seq_len frames (flattened for flat)."""
    _, pcfg = workspace[1][family]
    cfg = AudioTokensConfig(**{**pcfg.to_dict(), "normalize": normalize})
    prog = ServingProgram(cfg, device="cpu")
    seen = []
    forward = prog.model.forward
    prog.model.forward = lambda x, lengths=None: seen.append(x) or forward(
        x, lengths)
    pred = infer.Predictor(cfg, device="cpu")
    batch, lengths = prog.tokenizer.frontend.prepare_batch(WAVES[:2])
    prog(torch.from_numpy(batch), torch.from_numpy(lengths))
    for i, wave in enumerate(WAVES[:2]):
        tokens = pred.tokenizer.tokenize_waveforms([wave])[0]
        want = pred._inputs(wave, tokens)[0]
        np.testing.assert_allclose(seen[0][i].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    t = cfg.max_seq_len
    shape = {"simple": (2, t), "cnn": (2, t, cfg.n_mels),
             "baseline": (2, t * cfg.n_mels)}[family]
    assert tuple(seen[0].shape) == shape


@pytest.mark.parametrize("family", list(FAMILIES))
def test_manual_tester_matches_jax(workspace, family, capsys):
    base, fams = workspace
    jcfg, pcfg = fams[family]
    ytid = fixtures.ytid_for(3)
    rows = infer.ManualTester(pcfg, device="cpu").run(ytid, top_k=5)
    printed = capsys.readouterr().out.splitlines()
    ref = JaxManualTester(jcfg).run(ytid, top_k=5)
    ref_printed = capsys.readouterr().out.splitlines()
    assert printed[0] == ref_printed[0]  # "ytid: ... (N tokens)"
    assert len(printed) == len(ref_printed) == 6
    assert [r["rank"] for r in rows] == [1, 2, 3, 4, 5]
    scores = [r["score"] for r in rows]
    assert scores == sorted(scores, reverse=True)
    ref_by_class = {r["class_index"]: r for r in ref}
    assert set(ref_by_class) == {r["class_index"] for r in rows}
    truth = set(AudiosetMetadataProcessor(jcfg).get_ytid_labels(ytid))
    for r in rows:
        j = ref_by_class[r["class_index"]]
        assert (r["name"], r["is_true"]) == (j["name"], j["is_true"])
        assert r["is_true"] == (r["class_index"] in truth)
        np.testing.assert_allclose(r["score"], j["score"],
                                   **PROBS_TOL[family])
    assert any(r["is_true"] for r in rows) or not truth


def test_manual_tester_without_audio_raises(workspace):
    _, fams = workspace
    tester = infer.ManualTester(fams["simple"][1], device="cpu")
    assert tester.find_audio_file("nosuchclip") is None
    with pytest.raises(FileNotFoundError, match="nosuchclip"):
        tester.run("nosuchclip")


def test_entry_points_default_to_the_card(workspace, monkeypatch):
    """Predictor, ManualTester and ServingProgram(config) run on cuda:0
    unless asked otherwise, and fail without a card."""
    _, fams = workspace
    for entry in (infer.Predictor, infer.ManualTester,
                  ServingProgram.__init__):
        assert inspect.signature(entry).parameters["device"].default \
            == "cuda:0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        infer.Predictor(fams["simple"][1])


def test_infer_cli_on_cpu(workspace):
    """``python -m audio_tokens_tpu_torch.infer --device cpu`` prints the
    report with the ranked rows."""
    base, fams = workspace
    cfg = fams["cnn"][1]
    cmd = [sys.executable, "-m", "audio_tokens_tpu_torch.infer",
           "--ytid", fixtures.ytid_for(2), "--top_k", "4", "--device", "cpu",
           "--base_dir", str(base), "--checkpoint_dir", cfg.checkpoint_dir,
           "--model_type", "cnn", "--compute_dtype", "float32"]
    for field in ("num_classes", "vocab_size", "clip_seconds", "n_mels",
                  "n_fft", "hop_length", "max_seq_len"):
        cmd += [f"--{field}", str(getattr(cfg, field))]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"ytid: {fixtures.ytid_for(2)}  (")
    assert len(lines) == 5
    assert [int(line[1:6]) for line in lines[1:]] == [1, 2, 3, 4]


def test_run_pipeline_trains_and_serves_the_cnn(tmp_path):
    """``run_pipeline.main(cfg, "cpu")`` with the cnn on RawSTFTDataset: the
    staged stages, 2 epochs on the spectrograms, a checkpoint that
    ``ServingProgram(config)`` loads and serves from."""
    base = tmp_path / "ws"
    fixtures.make_workspace(base)
    jcfg = fixtures.test_config(base, model_type="cnn",
                                dataset_type="RawSTFTDataset")
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    cfg = AudioTokensConfig(**jcfg.to_dict())
    val_loss, val_metrics = run_pipeline.main(cfg, "cpu")
    assert np.isfinite(val_loss) and 0.0 <= val_metrics["mAP"] <= 1.0
    prog = ServingProgram(cfg, device="cpu")
    assert prog.model.compute_dtype == torch.bfloat16  # the default
    toks, probs = prog.predict_waveforms(WAVES[:2])
    assert probs.shape == (2, cfg.num_classes) and np.isfinite(probs).all()
    assert [len(t) for t in toks] == [1 + min(len(w), cfg.clip_samples)
                                      // cfg.hop_length for w in WAVES[:2]]
    shutil.rmtree(base / "spectrograms")
    with pytest.raises(ValueError, match="fused_pipeline"):
        run_pipeline.main(AudioTokensConfig(**{**cfg.to_dict(),
                                               "fused_pipeline": True}),
                          "cpu")
