"""The port's ``tools/serve_bench.py`` on the CPU: its corpus is the JAX
tool's byte for byte, and ``main()`` runs both branches (wav -> probs with
the request latencies; wav -> tokens over the int16 wire) with each decoder
(the config's ``audio_backend``) and prints the JAX tool's lines, naming the
decoder.  ``--tier`` runs the tokenizer at both tiers, its tokens those of
the tiers' plain version; a config flag of a tier overrides it."""

import numpy as np
import torch

from audio_tokens_tpu.tools.serve_bench import make_corpus as jax_make_corpus
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
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
                                       "--latency", "3",
                                       "--audio_backend", "python"])
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
    for decoder in ("python", "native"):
        result = serve_bench.main(SMALL + ["--wire", "i16",
                                           "--audio_backend", decoder])
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 2
        assert ("(disk->decode->tokens, double-buffered, tier=highest, "
                f"wire=i16, {decoder} decode)") in lines[1]
        assert "p50_ms" not in result and result["decoder"] == decoder
        assert result["decode_loop_ms"] > 0


def _record_tokenizer_calls(monkeypatch) -> list:
    seen = []
    orig = FusedTokenizer.tokens_from_padded

    def record(self, padded, lengths=None):
        out = orig(self, padded, lengths)
        seen.append((self, padded, out))
        return out

    monkeypatch.setattr(FusedTokenizer, "tokens_from_padded", record)
    return seen


def test_tiers_are_refused(monkeypatch, capsys):
    """``--tier`` (once refused) runs both tokenizer tiers: every batch's
    tokens are those of B1's plain version at the tier."""
    seen = _record_tokenizer_calls(monkeypatch)
    result = serve_bench.main(SMALL + ["--tier", "bf16x3"])
    assert result["tier"] == "bf16x3"
    assert "tier=bf16x3" in capsys.readouterr().out
    assert seen
    for tok, padded, out in seen:
        kern = tok.kernel
        assert (kern.tier, kern.vq_tier) == ("bf16x3", "bf16x3")
        assert torch.equal(out, kern.plain(padded))
        assert out.dtype == torch.int32 and np.all(out.numpy() >= 0)


def test_config_flags_override_tier(monkeypatch, capsys):
    """A config flag of either tier, given beside ``--tier``, wins over it
    (no duplicate keyword); the VQ tier runs apart from the DFT tier."""
    seen = _record_tokenizer_calls(monkeypatch)
    result = serve_bench.main(SMALL + ["--tier", "bf16x3",
                                       "--tokenizer_vq_precision", "default",
                                       "--audio_backend", "python"])
    assert result["tier"] == "bf16x3" and result["decoder"] == "python"
    assert "tier=bf16x3, wire=f32, python decode" in capsys.readouterr().out
    for tok, padded, out in seen:
        assert (tok.kernel.tier, tok.kernel.vq_tier) == ("bf16x3", "default")
        assert torch.equal(out, tok.kernel.plain(padded))
