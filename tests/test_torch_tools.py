"""The port's tools (``audio_tokens_tpu_torch/tools``) on the CPU, each
against its JAX counterpart (``audio_tokens_tpu/tools``) on the same inputs:

  * ``smoke_run.make_corpus``: the wav files, the ontology and the segment
    CSV byte-identical to the JAX tool's at 4 clips;
  * ``smoke_run`` (10 clips, 1 epoch) and ``scale_run`` (12 clips, 1 epoch,
    niter 2): their summary lines are the JAX tool's, ``scale_run``'s JSON
    has the JAX tool's keys and each stage's wire columns the JAX meter's;
  * ``bench_spill`` (``--gb 0.01``) prints the JAX tool's JSON keys, ``gb``
    from the spill's bytes; ``bench_loader`` (64 clips) the JAX tool's
    lines over the same batches;
  * the small tools on the smoke run's workspace, as JAX
    ``tests/test_infer_tools.py:109-165`` tests them: ``check_overlap``,
    ``verify_specs`` (a corrupted spectrogram -> 1), ``dataset_tester``,
    ``numpy_view`` and ``display_spec`` print the JAX tools' lines; the
    expander and the indexer read tar archives built in ``tmp_path``."""

import contextlib
import io
import json
import re
import runpy
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from audio_tokens_tpu.utils.profiling import WireMeter as JaxWireMeter
from tests import fixtures

SMOKE_STAGES = ["split", "spectrograms", "clustering", "tokenization",
                "training", "inference"]
# the JAX scale_run's JSON keys (audio_tokens_tpu/tools/scale_run.py:211-215)
SCALE_KEYS = {"n_clips", "timings", "wire", "val_mAP", "val_loss", "niter",
              "epochs", "fused"}


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _with_argv(fn, name: str, argv: list) -> str:
    """``fn()`` with ``sys.argv`` set to ``argv`` -> its stdout."""
    old = sys.argv
    sys.argv = [name] + [str(a) for a in argv]
    try:
        return _stdout(fn)[1]
    finally:
        sys.argv = old


def _script(module: str, argv: list) -> str:
    """Run a tool's ``__main__`` with ``argv`` -> its stdout."""
    return _with_argv(lambda: runpy.run_module(module, run_name="__main__"),
                      module, argv)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """``smoke_run`` on the CPU: 10 clips, 1 epoch -> (its result, its
    stdout, the workspace)."""
    from audio_tokens_tpu_torch.tools import smoke_run

    ws = tmp_path_factory.mktemp("smoke")
    res, out = _stdout(smoke_run.main, [
        "--device", "cpu", "--n_clips", "10", "--epochs", "1",
        "--workspace", str(ws)])
    return res, out, ws


def _cfgs(ws: Path):
    """The smoke run's config in each package."""
    from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    kw = dict(base_dir=str(ws), dataset_ratio=1.0, validation_ratio=0.2,
              num_classes=10, hidden_size=128, training_batch_size=8,
              device_batch_size=32)
    return JaxConfig(**kw), AudioTokensConfig(**kw)


def test_make_corpus_is_the_jax_corpus(tmp_path):
    from audio_tokens_tpu.tools.smoke_run import make_corpus as jax_corpus
    from audio_tokens_tpu_torch.tools.smoke_run import make_corpus

    jax_corpus(tmp_path / "jax", 4)
    make_corpus(tmp_path / "port", 4)
    ref = sorted(p.relative_to(tmp_path / "jax")
                 for p in (tmp_path / "jax").rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert got == ref and len(ref) == 6  # 4 wavs, ontology, segment CSV
    for rel in ref:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


def test_smoke_run_summary(smoke):
    res, out, ws = smoke
    lines = out[out.index("=== smoke run summary ==="):].splitlines()
    stages = [ln.split(":")[0].strip() for ln in lines[1:7]]
    assert stages == SMOKE_STAGES == list(res["timings"])
    assert re.search(r"final val mAP: \d\.\d{4} \(random ~0\.20\)", out)
    assert re.search(r"inference top-2 contains a true label: (True|False)",
                     out)
    assert 0.0 <= res["val_metrics"]["mAP"] <= 1.0
    assert len(res["rows"]) == 5
    assert (ws / "output" / "centroids.npy").exists()


def test_scale_run_json_has_the_jax_keys(tmp_path):
    from audio_tokens_tpu_torch.tools import scale_run

    res, out = _stdout(scale_run.main, [
        "--device", "cpu", "--n_clips", "12", "--epochs", "1", "--niter",
        "2", "--workspace", str(tmp_path), "--hidden_size", "32"])
    saved = json.loads((tmp_path / "output" / "scale_run_timings.json")
                       .read_text())
    assert set(saved) == SCALE_KEYS
    assert saved["niter"] == 2 and saved["fused"] and saved["n_clips"] == 12
    assert res["config"].hidden_size == 32  # the overlay reached the config
    keys = set(JaxWireMeter().delta(JaxWireMeter().snapshot()))
    assert list(saved["wire"]) == ["clustering", "tokenization", "training"]
    for stage, w in saved["wire"].items():
        assert set(w) == keys, stage
    # the fused device feed: waveforms up, the fit a device section
    assert saved["wire"]["clustering"]["h2d_mb"] > 0
    assert saved["wire"]["clustering"]["device_s"] > 0
    assert res["point_iters_per_s"] > 0
    header = out[out.index("=== scale run summary ==="):].splitlines()[1]
    assert header.split() == ["stage", "wall", "s", "h2d", "MB", "d2h", "MB",
                              "device", "s"]
    assert "binding stage at this scale:" in out
    # the projection's rate is the one this run measured
    assert f"this run's rate {res['point_iters_per_s'] / 1e6:.1f}M" in out


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_bench_spill_prints_the_jax_keys(tmp_path, wire):
    from audio_tokens_tpu.tools import bench_spill as jax_bench
    from audio_tokens_tpu_torch.tools import bench_spill

    argv = ["--gb", "0.01", "--rows-per-entry", "4096", "--wire", wire]
    res, out = _stdout(bench_spill.main, argv + ["--path",
                                                 str(tmp_path / "p")])
    ref = json.loads(_with_argv(jax_bench.main, "bench_spill", argv + [
        "--path", tmp_path / "j"]).splitlines()[-1])
    assert json.loads(out.splitlines()[-1]) == res
    assert list(res) == list(ref)
    assert res["wire"] == ref["wire"] == wire
    entries = int(0.01 * 2**30) // (4096 * 64 * (2 if wire == "bf16" else 4))
    assert res["gb"] == ref["gb"] == round(
        entries * 4096 * 64 * (2 if wire == "bf16" else 4) / 2**30, 2)
    assert all(res[k] > 0 for k in res if k.endswith("_mb_s"))
    assert not list((tmp_path / "p").iterdir())  # the file is cleaned up


def test_bench_loader_lines_match_jax(capsys, tmp_path, monkeypatch):
    import tempfile

    from audio_tokens_tpu.tools import bench_loader as jax_bench
    from audio_tokens_tpu_torch.tools import bench_loader

    # the JAX tool leaves its corpus in the temp dir
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    argv = ["--n_clips", "64", "--batch_size", "16", "--seq_len", "128",
            "--workers", "1,2"]
    rates = bench_loader.main(argv)
    got = capsys.readouterr().out
    ref = _with_argv(jax_bench.main, "bench_loader", argv)
    pattern = r"workers=(\d+): +[\d.]+ batches/s \( *\d+ clips/s\)"
    assert ([m.group(1) for m in re.finditer(pattern, got)]
            == [m.group(1) for m in re.finditer(pattern, ref)] == ["1", "2"])
    assert list(rates) == [1, 2] and all(r[0] > 0 for r in rates.values())


def test_check_overlap_tool(smoke, capsys):
    from audio_tokens_tpu.tools.check_overlap import \
        check_overlap as jax_check
    from audio_tokens_tpu_torch.tools.check_overlap import check_overlap

    jcfg, cfg = _cfgs(smoke[2])
    assert check_overlap(cfg.split_file) == jax_check(jcfg.split_file) == 0
    got, ref = capsys.readouterr().out.splitlines()
    assert got == ref and "no overlap" in got


def test_verify_specs_tool(smoke, capsys):
    from audio_tokens_tpu.tools.verify_specs import \
        verify_specs as jax_verify
    from audio_tokens_tpu_torch.tools.verify_specs import verify_specs

    jcfg, cfg = _cfgs(smoke[2])
    assert verify_specs(cfg) == jax_verify(jcfg) == 0
    got, ref = capsys.readouterr().out.splitlines()
    assert got == ref and "0 bad" in got
    bad = sorted((Path(cfg.source_spec_path) / "train").glob("*.npy"))[0]
    good = np.load(bad)
    np.save(bad, np.full_like(good, np.nan))
    try:
        assert verify_specs(cfg) == jax_verify(jcfg) == 1
    finally:
        np.save(bad, good)
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]
    assert any(line.startswith("BAD ") for line in out)


def test_dataset_tester_tool(smoke, capsys):
    from audio_tokens_tpu.tools.dataset_tester import main as jax_main
    from audio_tokens_tpu_torch.tools.dataset_tester import main

    jcfg, cfg = _cfgs(smoke[2])
    main(cfg)
    got = capsys.readouterr().out
    jax_main(jcfg)
    ref = capsys.readouterr().out
    assert got == ref
    assert "train:" in got and "overlap: 0" in got


def test_numpy_view_tool(smoke):
    spec = sorted((smoke[2] / "spectrograms" / "train").glob("*.npy"))[0]
    got = _script("audio_tokens_tpu_torch.tools.numpy_view", [spec])
    ref = _script("audio_tokens_tpu.tools.numpy_view", [spec])
    assert got == ref and got.startswith("shape=(64, ")


def test_display_spec_tool(smoke, tmp_path):
    pytest.importorskip("matplotlib")
    spec = sorted((smoke[2] / "spectrograms" / "train").glob("*.npy"))[0]
    got = _script("audio_tokens_tpu_torch.tools.display_spec",
                  [spec, tmp_path / "port.png"])
    ref = _script("audio_tokens_tpu.tools.display_spec",
                  [spec, tmp_path / "jax.png"])
    assert got.replace("port.png", "x") == ref.replace("jax.png", "x")
    import matplotlib.image as mpimg

    assert (mpimg.imread(tmp_path / "port.png").shape
            == mpimg.imread(tmp_path / "jax.png").shape)


def test_expander_and_indexer_tools(tmp_path, capsys):
    from audio_tokens_tpu.tools.audioset_expander import \
        expand_tar as jax_expand
    from audio_tokens_tpu.tools.sound_indexer import index_tars as jax_index
    from audio_tokens_tpu_torch.tools.audioset_expander import expand_tar
    from audio_tokens_tpu_torch.tools.sound_indexer import index_tars

    src = tmp_path / "payload"
    for i in range(3):
        fixtures.write_wav(src / f"ytAAA{i:03d}.wav",
                           fixtures.synth_clip(i, 0.3))
    (src / "notes.txt").write_text("not audio")
    fixtures.write_wav(src / "ytBBB000.WAV", fixtures.synth_clip(5, 0.2))
    tars = tmp_path / "tars"
    tars.mkdir()
    with tarfile.open(tars / "batch0.tar", "w") as tf:
        tf.add(src, arcname="payload")

    for expand, dest in ((expand_tar, "port"), (jax_expand, "jax")):
        assert expand(tars / "batch0.tar", tmp_path / dest, "bal_train") == 4
        assert expand(tars / "batch0.tar", tmp_path / dest, "bal_train") == 0
    files = {d: sorted(p.relative_to(tmp_path / d)
                       for p in (tmp_path / d).rglob("*") if p.is_file())
             for d in ("port", "jax")}
    assert files["port"] == files["jax"]
    assert Path("bal_train/yt/ytBBB000.wav") in files["port"]
    for rel in files["port"]:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes())

    assert index_tars(tars, tmp_path / "port.csv") == 4
    assert jax_index(tars, tmp_path / "jax.csv") == 4
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "jax.csv").read_text())
    got, ref = capsys.readouterr().out.splitlines()
    assert got.replace("port.csv", "x") == ref.replace("jax.csv", "x")
