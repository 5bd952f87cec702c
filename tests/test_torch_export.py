"""The serving export on the CPU: ``export_serving`` / ``load_serving`` round
trips against the live ``ServingProgram`` (lstm, bert and simple in both
forms, cnn portable, and the normalize route in kernel form), what each
artifact holds (no ``atk::`` op when portable; the path's ops, listed in
the manifest, in kernel form), a portable artifact loaded by
``torch.export.load`` in a process that never imports the package, the
port's portable artifact against the JAX package's (lstm, bert, simple and
cnn; both bert programs run the plain attention), and the CLI.

A round trip must reproduce the live program: tokens and n_valid exactly,
probs within rtol 1e-6 / atol 1e-7 (the JAX package's own bound,
``tests/test_export.py``).  Against the JAX artifact (same centroids, same
weights through ``convert.state_dict_for``): tokens under the near-tie
rule, n_valid exactly, probs at ``tests/test_torch_infer.py``'s
``PROBS_TOL`` (token families rtol 1e-5 / atol 1e-6; the spec family rtol
2e-4 / atol 1e-5, its log-mel frames summed in other orders), and the
manifests equal on every key the config decides."""

import dataclasses
import inspect
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.export import export_serving as jax_export_serving
from audio_tokens_tpu.export import load_serving as jax_load_serving
from audio_tokens_tpu.models import get_model as jax_get_model
from audio_tokens_tpu.train.checkpoint import save_checkpoint as jax_save
from audio_tokens_tpu_torch import export
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import state_dict_for
from audio_tokens_tpu_torch.export import (ServingProgram, export_serving,
                                           load_serving)
from audio_tokens_tpu_torch.models import get_model
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.train.checkpoint import save_checkpoint
from tests import fixtures
from tests.test_torch_families import randomize
from tests.test_torch_infer import PROBS_TOL

FAMILIES = {
    "lstm": dict(model_type="lstm"),
    "bert": dict(model_type="bert", transformer_attention="flash"),
    "simple": dict(model_type="simple"),
    "cnn": dict(model_type="cnn", dataset_type="RawSTFTDataset"),
}
JAX_FAMILIES = ("lstm", "bert", "simple", "cnn")  # held to the JAX artifact
PROBS_LIVE_TOL = dict(rtol=1e-6, atol=1e-7)
# one clip past the 3 s window: its length is clamped inside the program
WAVES = [fixtures.synth_clip(1), fixtures.synth_clip(4, seconds=3.5)]
BATCH = len(WAVES)
# the manifest keys the config decides (not format, platforms, custom_ops)
CONFIG_KEYS = ("portable", "batch_size", "alloc_len", "inputs", "outputs",
               "sample_rate", "clip_samples", "hop_length", "n_fft",
               "n_mels", "frames_max", "padded_len", "vocab_size",
               "num_classes", "model_type", "checkpoint", "class_names")


def _dummy_input(cfg, kind):
    t = cfg.max_seq_len
    if kind == "tokens":
        return jnp.zeros((1, t), jnp.int32)
    return jnp.zeros((1, t, cfg.n_mels), jnp.float32)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The fixture workspace, seeded unit centroids, and per family a port
    config whose checkpoint holds seeded weights; for ``JAX_FAMILIES`` a JAX
    config whose checkpoint holds the same weights.  ``artifact(family,
    portable, normalize)`` exports once and returns the directory."""
    base = tmp_path_factory.mktemp("export_ws")
    fixtures.make_workspace(base)
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((16, 32)).astype(np.float32)
    np.save(base / "output" / "centroids.npy",
            cents / np.linalg.norm(cents, axis=1, keepdims=True))
    configs = {}
    for name, fam in FAMILIES.items():
        jcfg = fixtures.test_config(
            base, compute_dtype="float32",
            checkpoint_dir=str(base / "jax_ckpt" / name), **fam)
        pcfg = AudioTokensConfig(**{
            **jcfg.to_dict(), "checkpoint_dir": str(base / "ckpt" / name)})
        pm = get_model(pcfg, "cpu", torch.Generator().manual_seed(0))
        if name in JAX_FAMILIES:
            kind = "spec" if name == "cnn" else "tokens"
            # the attention route holds no parameter: bert's are drawn on
            # the plain one, which the JAX package runs on the CPU
            init_cfg = dataclasses.replace(jcfg, transformer_attention="xla")
            params = randomize(jax_get_model(init_cfg).init(
                {"params": jax.random.key(0)}, _dummy_input(jcfg, kind),
                lengths=None, deterministic=True)["params"], rng)
            jax_save(jcfg.checkpoint_dir, "no-wandb-best", params)
            pm.load_state_dict(state_dict_for(name, params))
        save_checkpoint(pcfg.checkpoint_dir, "no-wandb-best", pm)
        configs[name] = (jcfg, pcfg)
    made = {}

    def artifact(name, portable, normalize=False):
        key = (name, portable, normalize)
        if key not in made:
            cfg = AudioTokensConfig(**{**configs[name][1].to_dict(),
                                       "normalize": normalize})
            made[key] = export_serving(
                cfg, base / f"serving_{name}_{portable}_{normalize}",
                batch_size=BATCH, portable=portable, device="cpu")
        return made[key]

    return configs, artifact


def _batch(cfg):
    """The WAVES batch, the long clip's true length past the window."""
    frontend = FusedTokenizer(cfg, np.ones((4, cfg.n_mels), np.float32),
                              "cpu").frontend
    batch, lengths = frontend.prepare_batch(WAVES)
    lengths[-1] = len(WAVES[-1])
    return torch.from_numpy(batch), torch.from_numpy(lengths)


def _atk_nodes(path):
    program = torch.export.load(path / export.PROGRAM_NAME)
    return sorted({n.target._schema.name
                   for m in program.graph_module.modules()
                   if isinstance(m, torch.fx.GraphModule)
                   for n in m.graph.nodes
                   if n.op == "call_function"
                   and hasattr(n.target, "_schema")
                   and n.target._schema.name.startswith("atk::")})


@pytest.mark.parametrize("family,portable,normalize,ops", [
    ("lstm", True, False, []),
    ("lstm", False, False, ["atk::lstm_fwd", "atk::tokenize"]),
    ("bert", True, False, []),
    ("bert", False, False, ["atk::flash_fwd", "atk::tokenize"]),
    ("simple", True, False, []),
    ("simple", False, False, ["atk::tokenize"]),
    ("simple", False, True, ["atk::vq_argmin"]),
    ("cnn", True, False, []),
])
def test_round_trip_equals_live_program(workspace, family, portable,
                                        normalize, ops):
    configs, artifact = workspace
    out = artifact(family, portable, normalize)
    module, manifest = load_serving(out, device="cpu")
    assert manifest["custom_ops"] == ops == _atk_nodes(out)
    assert manifest["platforms"] == (["cpu", "cuda"] if portable else ["cpu"])
    assert manifest["format"] == "torch.export.save"
    cfg = AudioTokensConfig(**{**configs[family][1].to_dict(),
                               "normalize": normalize})
    live = ServingProgram(cfg, device="cpu",
                          use_kernels=not portable)
    x, lengths = _batch(cfg)
    assert list(x.shape) == manifest["inputs"]["padded_batch"][1]
    with torch.inference_mode():
        got = module(x, lengths)
    ref = live(x, lengths)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(),
                               **PROBS_LIVE_TOL)


@pytest.mark.parametrize("portable", [False, True])
def test_export_under_a_profiler_holds_no_span(workspace, tmp_path,
                                               portable):
    """Exported while a profiler session records: no span opens while
    ``torch.export`` traces, the program holds no ``profiler::`` op
    (``export_serving`` refuses one) and the same ops as without it."""
    from torch.profiler import ProfilerActivity, profile

    configs, artifact = workspace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = export_serving(configs["lstm"][1], tmp_path / "traced",
                             batch_size=BATCH, portable=portable,
                             device="cpu")
    assert not [e.name for e in prof.events() if e.name.startswith("atk/")]
    program = torch.export.load(out / export.PROGRAM_NAME)
    assert export._graph_ops(program, "profiler::") == []
    assert _atk_nodes(out) == _atk_nodes(artifact("lstm", portable))


@pytest.mark.parametrize("portable", [False, True])
def test_tiered_program_round_trips(workspace, tmp_path, portable):
    """A program at the bf16 tiers (``tokenizer_precision`` bf16x3,
    ``tokenizer_vq_precision`` default): in kernel form the tiers and the
    split operands ride through ``atk::tokenize``; the portable form runs
    B1's plain tier arithmetic with no op.  Both reproduce the live
    program, whose tokens are B1's plain version at the tiers."""
    configs, _ = workspace
    cfg = AudioTokensConfig(**{**configs["simple"][1].to_dict(),
                               "tokenizer_precision": "bf16x3",
                               "tokenizer_vq_precision": "default"})
    out = export_serving(cfg, tmp_path / "tiered", batch_size=BATCH,
                         portable=portable, device="cpu")
    module, manifest = load_serving(out, device="cpu")
    assert _atk_nodes(out) == manifest["custom_ops"] == (
        [] if portable else ["atk::tokenize"])
    live = ServingProgram(cfg, device="cpu", use_kernels=not portable)
    x, lengths = _batch(cfg)
    with torch.inference_mode():
        got = module(x, lengths)
    ref = live(x, lengths)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(),
                               **PROBS_LIVE_TOL)
    kern = (live.tokenizer.plain_kernel if portable
            else live.tokenizer.kernel)
    assert (kern.tier, kern.vq_tier) == ("bf16x3", "default")
    assert torch.equal(got[0], kern.plain(x))


def test_portable_artifact_loads_without_the_package(workspace, tmp_path):
    """The portable lstm program (a scan for each direction, no custom op)
    loads and runs through ``torch.export.load`` alone in a fresh process
    that never imports the package, and answers as ``load_serving``'s."""
    configs, artifact = workspace
    out = artifact("lstm", True)
    assert _atk_nodes(out) == []
    x, lengths = _batch(configs["lstm"][1])
    torch.save((x, lengths), tmp_path / "inputs.pt")
    script = (
        "import sys, torch\n"
        f"x, lengths = torch.load({str(tmp_path / 'inputs.pt')!r})\n"
        f"program = torch.export.load({str(out / export.PROGRAM_NAME)!r})\n"
        "with torch.inference_mode():\n"
        "    outs = program.module()(x, lengths)\n"
        f"torch.save([o.clone() for o in outs], "
        f"{str(tmp_path / 'outs.pt')!r})\n"
        "assert not any(m.startswith('audio_tokens') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", script], check=True,
                   cwd=tmp_path, timeout=300)
    got = torch.load(tmp_path / "outs.pt")
    module, _ = load_serving(out, device="cpu")
    with torch.inference_mode():
        ref = module(x, lengths)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("family", JAX_FAMILIES)
def test_portable_artifact_matches_jax_portable_artifact(workspace, tmp_path,
                                                         family):
    configs, artifact = workspace
    jcfg, pcfg = configs[family]
    jax_out = jax_export_serving(jcfg, tmp_path / "jax", batch_size=BATCH,
                                 portable=True)
    exported, jax_manifest = jax_load_serving(jax_out)
    module, manifest = load_serving(artifact(family, True), device="cpu")
    for key in CONFIG_KEYS:
        assert manifest[key] == jax_manifest[key], key
    x, lengths = _batch(pcfg)
    ref = [np.array(r) for r in exported.call(jnp.asarray(x.numpy()),
                                                jnp.asarray(lengths.numpy()))]
    with torch.inference_mode():
        got = module(x, lengths)
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    frontend = FusedTokenizer(pcfg, np.ones((4, pcfg.n_mels), np.float32),
                              "cpu").frontend
    check_near_ties(l2_normalize(frontend.mel_frames(x)),
                    torch.from_numpy(np.load(pcfg.centroids_path)),
                    got[0], torch.from_numpy(ref[0]))
    np.testing.assert_allclose(got[2].numpy(), ref[2], **PROBS_TOL[
        "cnn" if family == "cnn" else "simple"])


def test_kernel_form_loads_only_on_its_device_type(workspace):
    _, artifact = workspace
    with pytest.raises(ValueError, match=r"runs on \['cpu'\]"):
        load_serving(artifact("simple", False), device="cuda:0")


def test_use_kernels_false_is_asked_for_only():
    """The plain routes are reached only by asking: ``use_kernels`` defaults
    to True (the device picks: kernels on a card, their plain versions on
    the CPU) everywhere; a program asked for no kernels serves bert with
    the plain attention; the export and load default to the card."""
    cfg = AudioTokensConfig(model_type="bert", hidden_size=64, num_layers=1,
                            transformer_attention="flash")
    for fn in (ServingProgram.__init__, FusedTokenizer.__init__,
               FusedTokenizer.from_artifacts, get_model):
        assert inspect.signature(fn).parameters["use_kernels"].default is True
    for fn in (export_serving, load_serving):
        assert inspect.signature(fn).parameters["device"].default == "cuda:0"
    tok = FusedTokenizer(cfg, np.ones((4, cfg.n_mels), np.float32), "cpu",
                         use_kernels=False)
    assert tok.kernel is None
    prog = ServingProgram.from_components(cfg, tok, device="cpu")
    assert prog.config.transformer_attention == "xla"
    assert prog.model.attention_impl == "xla"


def test_cli_exports_a_loadable_program(workspace, tmp_path):
    configs, _ = workspace
    pcfg = configs["simple"][1]
    (tmp_path / "cfg.json").write_text(json.dumps(pcfg.to_dict()))
    out = export.main(["--out", str(tmp_path / "serving"), "--batch", "2",
                       "--portable", "false", "--device", "cpu",
                       "--config", str(tmp_path / "cfg.json")])
    module, manifest = load_serving(out, device="cpu")
    assert manifest["batch_size"] == 2 and not manifest["portable"]
    assert manifest["custom_ops"] == ["atk::tokenize"]
    assert manifest["class_names"] is not None
    assert len(manifest["class_names"]) == pcfg.num_classes
    with torch.inference_mode():
        tokens, n_valid, probs = module(*_batch(pcfg))
    assert probs.shape == (2, pcfg.num_classes)
