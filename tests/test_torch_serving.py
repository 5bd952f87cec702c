"""The whole slice: port ServingProgram (plain versions of B1/B2/B3 on the
CPU) vs the JAX ServingProgram with the same centroids and, through
convert.py, the same classifier weights.  Tokens equal except at near-ties,
n_valid equal, probs to rtol 1e-5 / atol 1e-6 (tests/test_export.py)."""

import ctypes
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
from audio_tokens_tpu.export import ServingProgram as JaxServing
from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.convert import lstm_state_dict
from audio_tokens_tpu_torch.export import ServingProgram
from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize
from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
from audio_tokens_tpu_torch.utils import staging
from audio_tokens_tpu_torch.utils.staging import (STAGE_CHUNK_BYTES,
                                                  STAGE_SLOTS, STAGE_THREADS,
                                                  H2DStats, HostStager, bind,
                                                  route, stage_plan)

SLICE = dict(common_sr=22050, n_mels=32, n_fft=256, hop_length=128,
             clip_seconds=1.5, vocab_size=48, lstm_embed_dim=16,
             lstm_hidden_dim=32, num_classes=7, max_seq_len=272,
             lstm_backend="xla")


def _programs(rng, **over):
    cents = rng.standard_normal((48, 32)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    jcfg, pcfg = JaxConfig(**SLICE, **over), AudioTokensConfig(**SLICE, **over)
    jprog = JaxServing.from_components(
        jcfg, JaxTokenizer(jcfg, cents, use_pallas=False))
    pprog = ServingProgram.from_components(
        pcfg, FusedTokenizer(pcfg, cents, "cpu"),
        lstm_state_dict(jax.device_get(jprog.params)), device="cpu")
    return jprog, pprog


def _unit_features(prog, x, lengths):
    tok = prog.tokenizer
    if tok.kernel is not None:
        return l2_normalize(tok.kernel.log_mel_plain(x))
    return l2_normalize(tok.frontend.normalized(x, lengths).transpose(1, 2))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("reference_compat", [True, False])
def test_slice_matches_jax(rng, normalize, reference_compat):
    jprog, pprog = _programs(rng, normalize=normalize,
                             reference_compat=reference_compat)
    # one clip longer than the window: lengths clamp to clip_samples
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.4, 0.9, 1.5, 1.7)]
    batch, lengths = pprog.tokenizer.frontend.prepare_batch(clips)
    lengths[3] = len(clips[3])
    ref = jprog(jnp.asarray(batch), jnp.asarray(lengths))
    x, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    tokens, n_valid, probs = pprog(x, ln)
    clamped = torch.clamp(ln, max=pprog.config.clip_samples)
    check_near_ties(_unit_features(pprog, x, clamped),
                    pprog.tokenizer.centroids, tokens,
                    torch.tensor(np.asarray(ref[0])))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref[2]),
                               rtol=1e-5, atol=1e-6)


def test_reference_compat_changes_the_answer(rng):
    """The two branches really differ (all-ones mask vs valid lengths), so
    the parity above covers two behaviors, not one."""
    _, compat = _programs(rng, reference_compat=True)
    _, fixed = _programs(np.random.default_rng(0), reference_compat=False)
    fixed.model.load_state_dict(compat.model.state_dict())
    clips = [rng.standard_normal(int(22050 * 0.8)).astype(np.float32)]
    batch, lengths = compat.tokenizer.frontend.prepare_batch(clips)
    a = compat(torch.from_numpy(batch), torch.from_numpy(lengths))[2]
    b = fixed(torch.from_numpy(batch), torch.from_numpy(lengths))[2]
    assert not torch.allclose(a, b)


def test_predict_waveforms_matches_jax(rng):
    jprog, pprog = _programs(rng)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.2, 0.7)]
    ref_toks, ref_probs = jprog.predict_waveforms(clips)
    toks, probs = pprog.predict_waveforms(clips)
    assert [len(t) for t in toks] == [len(t) for t in ref_toks]
    for t, r in zip(toks, ref_toks):
        assert t.dtype == np.int64 and (t != r).mean() <= 1e-3
    np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)


def test_program_and_tokenizer_devices_must_match(rng):
    cfg = AudioTokensConfig(**SLICE)
    tok = FusedTokenizer(cfg, np.zeros((48, 32), np.float32), "cpu")
    with pytest.raises(ValueError, match="tokenizer on cpu"):
        ServingProgram.from_components(cfg, tok, device="meta")


# -- the input copy (utils/staging): the pool of csrc/staging.cu built with
# g++ against tests/cuda_stub/cuda_runtime.h, whose copies stay in flight
# until waited on; tests/test_torch_cuda.py holds it to the card

ROW = 221012  # the serving cells' row: 10 s at 22,050 Hz + n_fft
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("staging") / "libstaging_stub.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", str(REPO / "tests" / "cuda_stub"), "-x", "c++",
         str(REPO / "audio_tokens_tpu_torch" / "csrc" / "staging.cu"),
         "-o", str(out)], check=True)
    return bind(ctypes.CDLL(str(out)))


class _StubStager(HostStager):
    """HostStager on the stub: host tensors stand in for the device's, and
    the compute stream's wait lands every copy issued."""

    def __init__(self, lib):
        super().__init__(torch.device("cuda", 0))
        self._stub = lib

    def _load(self):
        return self._stub

    def _side_handle(self):
        return None

    def _empty(self, shape, dtype):
        return torch.full(shape, -1, dtype=dtype)

    def _compute_waits(self, dst):
        self._stub.stub_flush()

    def _direct(self, x):
        return x.clone(), object()


def _wire(batch, dtype, row=ROW, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, row)).astype(np.float32))
    return x if dtype == torch.float32 else (x * 3000).to(torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("batch", [1, 7, 64, 65])
def test_chunk_plan_covers_every_row_once_in_whole_clips(stub_lib, batch,
                                                         dtype):
    row_bytes = ROW * torch.tensor([], dtype=dtype).element_size()
    lo, hi, slot, worker = stage_plan(batch, row_bytes, STAGE_CHUNK_BYTES,
                                      STAGE_THREADS, STAGE_SLOTS)
    assert sorted(r for a, b in zip(lo, hi) for r in range(a, b)) == list(
        range(batch))
    assert all(b - a == 1 or (b - a) * row_bytes <= STAGE_CHUNK_BYTES
               for a, b in zip(lo, hi))
    assert (slot // STAGE_SLOTS == worker).all()  # a worker's own slots
    if batch * row_bytes <= STAGE_CHUNK_BYTES:
        assert len(lo) == 1 and worker[0] == 0  # the calling thread's
    else:
        assert worker.max() == min(batch, STAGE_THREADS) - 1
    # the staged copy lands every byte where it belongs
    x = _wire(batch, dtype)
    st = _StubStager(stub_lib)
    y, read = st.to_device(x)
    assert read is None and y.dtype == dtype and torch.equal(y, x)
    assert (st.stats.staged, st.stats.chunks, st.stats.bytes) == (
        1, len(lo), batch * row_bytes)
    st.close()


@pytest.mark.parametrize("threads,slots",
                         [(1, 2), (3, 2), (2, 3), (4, 1), (16, 2)])
def test_ring_refills_no_slot_under_a_copy_in_flight(stub_lib, monkeypatch,
                                                     threads, slots):
    """Every copy stays in flight until waited on: a slot is refilled only
    after its last copy's event has completed (else the copies land the
    later chunk's bytes), and each such wait counts."""
    for name, value in (("THREADS", threads), ("CHUNK_BYTES", 3 * 400),
                        ("SLOTS", slots)):
        monkeypatch.setattr(staging, f"STAGE_{name}", value)
    st = _StubStager(stub_lib)
    xs = [_wire(n, torch.float32, row=100, seed=n) for n in (29, 11, 2, 200)]
    most = least = 0
    for x in xs:
        y, _ = st.to_device(x)
        assert torch.equal(y, x)
        _, _, _, worker = stage_plan(len(x), 400, 3 * 400, threads, slots)
        # the compute stream's wait lands a batch's copies: only a worker's
        # chunks beyond its slots can wait, and the first such fill does;
        # copies land in order, so a wait may land another worker's too
        refills = sum(max(0, int((worker == w).sum()) - slots)
                      for w in range(threads))
        most += refills
        least += refills > 0
    assert 0 < least <= st.stats.slot_waits <= most
    if threads == 1:
        assert st.stats.slot_waits == most
    st.close()


def test_cpu_program_bypasses_the_ring(rng):
    _, prog = _programs(rng)
    clips = [rng.standard_normal(int(22050 * 1.2)).astype(np.float32)]
    batch, lengths = prog.tokenizer.frontend.prepare_batch(clips)
    prog(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert prog.h2d_stats == H2DStats(bypassed=1)


def test_inputs_take_their_route(stub_lib, monkeypatch):
    cuda = torch.device("cuda", 0)
    small, large = _wire(1, torch.float32), _wire(20, torch.float32)
    assert route(torch.empty(3, 4, device="meta"), cuda) == "bypassed"
    assert route(large, torch.device("cpu")) == "bypassed"
    assert route(large[:0], cuda) == "bypassed"  # no bytes to stage
    assert route(small, cuda) == route(large, cuda) == "staged"
    st = _StubStager(stub_lib)
    views = (small, large, large[::2], large[:, 7:], large[3:9])
    for x in views:  # row views: read by their stride, contiguous in the ring
        y, _ = st.to_device(x)
        assert torch.equal(y, x) and y.is_contiguous()
    assert (st.stats.staged, st.stats.direct) == (5, 0)
    assert st.stats.chunks == sum(len(stage_plan(
        len(x), x[0].numel() * 4, STAGE_CHUNK_BYTES, STAGE_THREADS,
        STAGE_SLOTS)[0]) for x in views)
    cols = _wire(8, torch.float32, row=64).t()  # rows strided: made whole
    y, _ = st.to_device(cols)
    assert torch.equal(y, cols)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    assert route(large, cuda) == "direct"
    y, read = st.to_device(large)
    assert torch.equal(y, large) and read is not None
    assert (st.stats.staged, st.stats.direct, st.stats.bypassed) == (6, 1, 0)
    st.close()
