"""The port's ``tools/serve_bench.py`` on the CPU: its corpus is the JAX
tool's byte for byte, and ``main()`` runs both branches (wav -> probs with
the request latencies; wav -> tokens over the int16 wire) and prints the
JAX tool's lines.  The tiers are refused, naming ROADMAP A6."""

import pytest

from audio_tokens_tpu.tools.serve_bench import make_corpus as jax_make_corpus
from audio_tokens_tpu_torch.tools import serve_bench

SMALL = ["--device", "cpu", "--n_clips", "4", "--batch", "2", "--seconds",
         "0.5", "--vocab", "16"]


def test_make_corpus_writes_the_jax_bytes(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = jax_make_corpus(tmp_path / "jax", 3, 0.5, 22050)
    got = serve_bench.make_corpus(tmp_path / "port", 3, 0.5, 22050)
    assert [p.name for p in got] == [p.name for p in ref]
    for g, r in zip(got, ref):
        assert g.read_bytes() == r.read_bytes()


def test_main_classifies_and_measures_latency(capsys):
    result = serve_bench.main(SMALL + ["--classify", "simple",
                                       "--latency", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("stages per 2-clip batch: decode ")
    assert lines[1].startswith(
        "serving (disk->decode->probs[simple], double-buffered, "
        "tier=highest, wire=f32, python decode): ")
    assert lines[2].startswith(
        "request latency (batch=1, disk->decode->probs[simple], n=3): p50 ")
    assert result["n_clips"] == 4 and result["clips_per_s"] > 0
    assert (0 < result["p50_ms"] <= result["p90_ms"] <= result["p99_ms"]
            <= result["max_ms"])


def test_main_tokenizes_over_the_int16_wire(capsys):
    result = serve_bench.main(SMALL + ["--wire", "i16"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert "(disk->decode->tokens, double-buffered, tier=highest, wire=i16, "\
        "python decode)" in lines[1]
    assert "p50_ms" not in result


def test_tiers_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        serve_bench.main(SMALL + ["--tier", "high"])
