"""The PyTorch port's package rules: its copies of framework-free modules
equal the JAX package's originals, it never imports jax, it refuses options
it has not ported.  The kernels' own tests are in test_torch_cuda.py."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_tokens_tpu import config as jax_config
from audio_tokens_tpu.ops import mel as jax_mel
from audio_tokens_tpu_torch import config as port_config
from audio_tokens_tpu_torch.ops import mel as port_mel

REPO = Path(__file__).resolve().parents[1]


def test_config_copy_equals_original():
    """Same fields, annotations and defaults; same derived instance."""
    jf = dataclasses.fields(jax_config.AudioTokensConfig)
    pf = dataclasses.fields(port_config.AudioTokensConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    for a, b in zip(pf, jf):
        assert a.type == b.type, a.name
        assert a.default == b.default, a.name
        if b.default_factory is not dataclasses.MISSING:
            assert a.default_factory() == b.default_factory(), a.name
    assert (port_config.AudioTokensConfig().to_dict()
            == jax_config.AudioTokensConfig().to_dict())


@pytest.mark.parametrize("argv", [
    ["--model_type", "lstm", "--normalize", "true", "--vocab_size", "48"],
    ["--clip_seconds=1.5", "--audio_source_sets", "a,b",
     "--max_points_per_centroid", "none"],
])
def test_config_cli_overlay_equals_original(argv):
    p = port_config.AudioTokensConfig
    j = jax_config.AudioTokensConfig
    assert p.parse_overrides(argv) == j.parse_overrides(argv)
    flat = [t for tok in argv for t in tok.split("=", 1)]
    assert p.from_args(flat).to_dict() == j.from_args(flat).to_dict()


@pytest.mark.parametrize("name,args", [
    ("hann_window", (400,)),
    ("mel_filterbank", (257, 64, 22050)),
    ("mel_filterbank", (129, 32, 16000, 20.0, 7000.0)),
    ("dft_filters", (512,)),
    ("dft_filters", (256,)),
    ("num_frames", (220500, 128)),
])
def test_numpy_filters_equal_originals(name, args):
    np.testing.assert_array_equal(getattr(port_mel, name)(*args),
                                  getattr(jax_mel, name)(*args))


def test_reflect_pad_clip_equals_original(rng):
    for n in (300, 1000, 2000):
        w = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(port_mel.reflect_pad_clip(w, 1500, 256),
                                      jax_mel.reflect_pad_clip(w, 1500, 256))


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, import without jax or
    the JAX package (a fresh interpreter: this process has both)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_tokens_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'audio_tokens_tpu' or m.startswith('audio_tokens_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules"
        " if m.startswith('audio_tokens_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
    assert int(out.stdout.split()[1]) >= 15  # every module was imported


@pytest.mark.parametrize("override,match", [
    ({"use_convolution": True}, "use_convolution"),
    ({"tokenizer_precision": "bf16x3"}, "tokenizer_precision"),
    ({"tokenizer_vq_precision": "default"}, "tokenizer_vq_precision"),
])
def test_unported_tokenizer_options_refused(override, match):
    """The tokenizer options once refused (``match`` names each) run: the
    tokens equal the JAX tokenizer's with the same options except at the
    near-ties of the coarsest tier (the conv with the port's weights
    carried over; the tiers against the JAX kernel in interpret mode)."""
    import jax.numpy as jnp

    from audio_tokens_tpu.ops import pallas_tokenizer as jax_pt
    from audio_tokens_tpu.ops.conv_features import ConvFeatures as JaxConv
    from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer
    from audio_tokens_tpu.utils.seeding import key_for
    from audio_tokens_tpu_torch.ops.conv_features import ConvFeatures
    from audio_tokens_tpu_torch.ops.tiers import check_tier_ties
    from audio_tokens_tpu_torch.ops.vq import l2_normalize
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    kw = dict(n_mels=8, n_fft=64, hop_length=32, clip_seconds=0.1)
    cfg = port_config.AudioTokensConfig(**kw, **override)
    assert getattr(cfg, match) == override[match]
    rng = np.random.default_rng(3)
    d = cfg.feature_dim
    cents = rng.standard_normal((40, d)).astype(np.float32)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (2205, 1500)]
    conv = ConvFeatures(cfg.num_kernels, cfg.kernel_size, 0) \
        if cfg.use_convolution else None
    tok = FusedTokenizer(cfg, cents, "cpu", conv=conv)
    batch, _ = tok.frontend.prepare_batch(waves)
    x = torch.from_numpy(batch)
    got = tok.tokens_from_padded(x)
    feats = tok.frontend.mel_frames(x).reshape(-1, cfg.n_mels)
    if conv is not None:
        assert tok.kernel is None
        jconv = JaxConv(cfg.num_kernels, cfg.kernel_size, key_for(0, "c"))
        jconv.load_state_dict({k: v.numpy() for k, v in
                               conv.state_dict().items()})
        jtok = JaxTokenizer(jax_config.AudioTokensConfig(**kw, **override),
                            cents, conv=jconv, use_pallas=False)
        ref = np.asarray(jtok.tokens_from_padded(jnp.asarray(batch)))
        feats, tier = conv(feats), "highest"
    else:
        kern = jax_pt.TokenizerKernel(
            cfg.common_sr, cfg.n_mels, cfg.n_fft, cfg.hop_length,
            tok.frontend.frames_max, cents, tier=cfg.tokenizer_precision,
            vq_tier=cfg.tokenizer_vq_precision, interpret=True)
        wide = np.zeros((len(batch), kern.n_blocks * kern.hop), np.float32)
        wide[:, :batch.shape[1]] = batch
        ref = np.asarray(kern(jnp.asarray(wide)))
        feats = tok.kernel.log_mel_plain(x).reshape(-1, cfg.n_mels)
        tier = ("default" if "default" in override.values() else "bf16x3")
    check_tier_ties(l2_normalize(feats), torch.from_numpy(cents), got,
                    torch.from_numpy(ref), tier)


def test_unported_serving_entry_points_refused():
    """``serve_sharded`` on a mesh of one process is ``serve``, and a batch
    that does not split over the data axis is refused with the JAX
    message."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer
    from audio_tokens_tpu_torch import export
    from audio_tokens_tpu_torch.parallel.mesh import DataGroup, make_mesh
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    kw = dict(clip_seconds=1.0, n_mels=32, n_fft=256, hop_length=128)
    cfg = port_config.AudioTokensConfig(model_type="simple", hidden_size=8,
                                        **kw)
    cents = np.random.default_rng(0).standard_normal(
        (4, cfg.n_mels)).astype(np.float32)
    prog = export.ServingProgram.from_components(
        cfg, FusedTokenizer(cfg, cents, "cpu"), device="cpu")
    batch, lengths = prog.tokenizer.frontend.prepare_batch(
        [np.sin(np.arange(n) / 7.0).astype(np.float32)
         for n in (22050, 9000, 15000)])
    x, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    for got, want in zip(prog.serve_sharded(x, ln, make_mesh()),
                         prog.serve(x, ln)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    jtok = JaxTokenizer(jax_config.AudioTokensConfig(**kw), cents)
    with pytest.raises(ValueError) as jax_err:
        jtok.tokens_sharded(batch, JaxMesh(np.array(jax.devices()[:2]),
                                           ("data",)))
    two = DataGroup()
    two.size = 2  # a stand-in data axis of 2 ranks
    with pytest.raises(ValueError, match=str(jax_err.value)):
        prog.serve_sharded(x, ln, two)


def test_build_command_targets_hopper_without_fast_math():
    from audio_tokens_tpu_torch.ops import _build

    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
    # the build lands in a gitignored directory of the checkout
    assert _build.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_flash_backward_ab_variants_name_knobs_of_the_kernel_source(
        monkeypatch):
    """Every knob the A/B tool's default attention variants set is a
    ``#ifndef`` knob of ``csrc/attention.cu`` (a stale name would silently
    build the default again), and a variant's defines reach the nvcc command
    line as ``-D``."""
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.tools import kernel_ab

    _assert_ab_variants_name_knobs("attention")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("attention", REPO / "build" / "x.so",
                              ["ATK_TILE_SKIP=0"])
    assert "-DATK_TILE_SKIP=0" in cmd and cmd[-1].endswith("attention.cu")
    assert set(kernel_ab.DEFAULT_VARIANTS) == set(kernel_ab.PTXAS_KERNELS)


def test_lstm_ab_variants_name_knobs_of_the_kernel_source():
    """The same for the A/B tool's B4 variants and ``csrc/lstm.cu``, and
    the B4 instantiations whose registers it reports are the ones the launch
    shape can pick."""
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.tools import kernel_ab

    _assert_ab_variants_name_knobs("lstm")
    source = (_build.CSRC / "lstm.cu").read_text()
    for part, _ in kernel_ab.PTXAS_KERNELS["lstm"]:
        u, threads = part.split("ILi")[1].rstrip("E").split("ELi")
        assert f"lstm_bwd_kernel<{u}, {threads}>" in source, part


@pytest.mark.parametrize("kernel", ["lstm-fwd", "tokenizer"])
def test_b1_b3_ab_variants_name_knobs_of_the_kernel_source(kernel):
    """The A/B tool's B3 and B1 variants set knobs their sources define,
    and the kernels whose registers it reports are in those sources."""
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.tools import kernel_ab

    _assert_ab_variants_name_knobs(kernel)
    source = (_build.CSRC / f"{kernel_ab.SOURCES[kernel]}.cu").read_text()
    for part, _ in kernel_ab.PTXAS_KERNELS[kernel]:
        name = part.split("I")[0].rstrip("v")  # the mangled name's base
        assert f"{name}(" in source or f"{name}<" in source, part
    assert set(kernel_ab.TIMER_PHASES) <= set(kernel_ab.CASES)


def test_sums_ab_variants_name_knobs_of_the_kernel_source():
    """The A/B tool's variants of the centroid sums set knobs that
    ``csrc/kmeans.cu`` defines, and the kernels whose registers it reports
    are in that source."""
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.tools import kernel_ab

    _assert_ab_variants_name_knobs("kmeans")
    source = (_build.CSRC / "kmeans.cu").read_text()
    for part, _ in kernel_ab.PTXAS_KERNELS["kmeans"]:
        assert f"{part.split('I')[0]}(" in source, part


@pytest.mark.parametrize("kernel", ["lstm-dw", "vq"])
def test_dw_hh_b2_ab_variants_name_knobs_of_the_kernel_source(kernel):
    """The A/B tool's variants of B4's ``dw_hh`` GEMM and of B2 set knobs
    their sources define."""
    _assert_ab_variants_name_knobs(kernel)


def test_f32_attention_ab_variants_name_knobs_of_the_kernel_source():
    """The A/B tool's variants of B5's f32 pair set knobs of
    ``csrc/attention.cu``, and the 3xTF32 kernels whose registers it reports
    are in that source."""
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.tools import kernel_ab

    _assert_ab_variants_name_knobs("attention-f32")
    source = (_build.CSRC / "attention.cu").read_text()
    for part, label in kernel_ab.PTXAS_KERNELS["attention-f32"]:
        if "3xTF32" in label:
            assert f"{part}_kernel(" in source, part


def test_sass_ops_counts_opcodes_of_the_named_kernels():
    """``tools/sass_ops.py`` counts each kernel's opcodes in ``cuobjdump
    -sass`` output, predicates left out, only for the kernels asked for."""
    from audio_tokens_tpu_torch.tools.sass_ops import opcode_counts

    sass = """
\tcode for sm_90a
\t\tFunction : _ZN3abc6kern_aEPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0020*/              @!P0 HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0030*/               @P1 BRA 0x40 ;
\t\tFunction : _ZN3abc6kern_bEPf
        /*0000*/                   EXIT ;
"""
    counts = opcode_counts(sass, ["kern_a"])
    assert list(counts) == ["_ZN3abc6kern_aEPf"]
    assert counts["_ZN3abc6kern_aEPf"] == {"LDC": 1, "HMMA": 2, "BRA": 1}
    assert set(opcode_counts(sass)) == {"_ZN3abc6kern_aEPf",
                                        "_ZN3abc6kern_bEPf"}


def _assert_ab_variants_name_knobs(kernel: str) -> None:
    from audio_tokens_tpu_torch.ops import _build
    from audio_tokens_tpu_torch.tools import kernel_ab

    source = (_build.CSRC / f"{kernel_ab.SOURCES[kernel]}.cu").read_text()
    variants = kernel_ab.DEFAULT_VARIANTS[kernel]
    names = [v.partition(":")[0] for v in variants]
    assert names[0] == "default" and len(set(names)) == len(names)
    for variant in variants:
        for define in filter(None, variant.partition(":")[2].split(",")):
            knob, _, value = define.partition("=")
            assert f"#ifndef {knob}\n" in source, variant
            assert value.isdigit(), variant
