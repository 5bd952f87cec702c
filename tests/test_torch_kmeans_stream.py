"""The port's streaming K-means (``audio_tokens_tpu_torch/ops/kmeans.py::
kmeans_fit_streaming`` and the ``full`` mode of
``processors/cluster_creator.py`` over the streaming threshold) against the
JAX package's on the CPU, numpy inputs from a seed.

Tolerances: fits of the same stream from the same init agree within 1e-5
(centroids) and 1e-5 relative (objective): the JAX fit adds its
super-batches' f32 one-hot sums, the port f64 sorted-row sums.  Random
init rows, the bf16 wire's bits and the checkpoint's signature are held
exactly.  Within the port, every replay of a stream (host cache, device
cache, disk spill, a resumed fit) is held bit-equal to re-streaming it."""

import logging
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
from audio_tokens_tpu.data.splitter import DatasetSplitter
from audio_tokens_tpu.ops import kmeans as jax_km
from audio_tokens_tpu.processors.cluster_creator import (
    ClusterCreator as JaxClusterCreator,
)
from audio_tokens_tpu_torch.ops import kmeans as km
from audio_tokens_tpu_torch.processors import (
    ClusterCreator,
    SpectrogramGenerator,
)
from tests import fixtures
from tests.test_torch_pipeline import port_config

TOL = 1e-5
K, D, N = 8, 12, 3000
SB, CHUNK = 1024, 256  # capacity 1024: 3 super-batches of N rows
LOGGER = "audio_tokens_tpu_torch.ops.kmeans"


def _blobs(seed=0, n=N, d=D, k=K):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 2.0
    x = centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))
    return x.astype(np.float32), rng


class Stream:
    """A stream of 700-row pieces that counts its passes."""

    def __init__(self, x, piece=700):
        self.x, self.piece, self.calls = x, piece, 0

    def __call__(self):
        self.calls += 1
        return iter([self.x[i : i + self.piece]
                     for i in range(0, len(self.x), self.piece)])


def _fit(stream, niter=4, **kw):
    kw.setdefault("superbatch_rows", SB)
    kw.setdefault("chunk", CHUNK)
    c, obj, n = km.kmeans_fit_streaming(stream, K, niter, d=D, device="cpu",
                                        **kw)
    assert c.device.type == "cpu" and c.dtype == torch.float32
    return c, obj, n


def _same(a, b):
    assert torch.equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]


@pytest.fixture(scope="module")
def data():
    x, rng = _blobs()
    init = x[rng.choice(N, K, replace=False)].copy()
    init_dup = init.copy()
    init_dup[1] = init_dup[0]  # cluster 1 stays empty: split_largest runs
    return x, init, init_dup


@pytest.fixture(scope="module")
def restreamed(data):
    """The plain re-streamed fit every replay is held to."""
    x, init, _ = data
    return _fit(Stream(x), init_centroids=init)


@pytest.mark.parametrize("init_mode,policy,wire", [
    ("given", "keep", "f32"),
    ("random", "keep", "f32"),
    ("given", "split_largest", "f32"),
    ("given", "keep", "bf16"),
])
def test_fit_matches_jax(data, init_mode, policy, wire):
    x, init, init_dup = data
    kw = dict(superbatch_rows=SB, chunk=CHUNK, empty_policy=policy, seed=3)
    if init_mode == "given":
        kw["init_centroids"] = init_dup if policy == "split_largest" else init
    jc, jobj, jn = jax_km.kmeans_fit_streaming(
        Stream(x), K, 4, d=D,
        wire_dtype=ml_dtypes.bfloat16 if wire == "bf16" else np.float32, **kw)
    pc, pobj, pn = _fit(Stream(x), wire_dtype=km.WIRES[wire], **kw)
    np.testing.assert_allclose(pc.numpy(), jc, atol=TOL, rtol=0)
    assert abs(pobj - jobj) <= TOL * abs(jobj)
    assert pn == jn == N


def test_random_init_draws_the_jax_rows(data):
    """One iteration from the first super-batch's draw: the init is fixed
    by the rows drawn, so both fits land within 1e-5 only if the draws
    picked the same rows of the same super-batch."""
    x, _, _ = data
    for seed in (0, 7):
        jc, _, _ = jax_km.kmeans_fit_streaming(
            Stream(x[::-1].copy()), K, 1, superbatch_rows=SB, chunk=CHUNK,
            seed=seed)
        pc, _, _ = _fit(Stream(x[::-1].copy()), niter=1, seed=seed)
        np.testing.assert_allclose(pc.numpy(), jc, atol=TOL, rtol=0)


def test_bf16_wire_bits_equal_ml_dtypes_rounding():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((64, D)).astype(np.float32) * 10.0
    # ties to even, subnormals, signed zeros, infinities, the largest
    # finite values and values that round up into the next binade
    bits = np.array([0x3F808000, 0x3F818000, 0x3F80C000, 0x00000001,
                     0x00008000, 0x80000000, 0x7F800000, 0xFF800000,
                     0x7F7FFFFF, 0x3FFFFFFF, 0xBF7FFFFF, 0x007FFFFF],
                    np.uint32)
    rows[0] = bits.view(np.float32)
    want = rows.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = km.to_wire(rows, torch.bfloat16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    feeder = km._SuperbatchFeeder(16, D, torch.bfloat16)
    packed = np.concatenate([b[:f] for b, f in feeder.feeds(
        iter([rows[:5], rows[5:40], rows[40:]]))])
    np.testing.assert_array_equal(packed, want)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_feeder_packs_the_jax_superbatches(data, wire):
    """Same boundaries, fills and values as the JAX feeder, at the JAX
    capacity rule."""
    x, _, _ = data
    pieces = [x[:5], x[5:905], x[905:908], x[908:2500]]
    capacity = max(1, SB // CHUNK) * CHUNK
    jdt = ml_dtypes.bfloat16 if wire == "bf16" else np.float32
    ref = list(jax_km._SuperbatchFeeder(capacity, D, jdt).feeds(iter(pieces)))
    got = list(km._SuperbatchFeeder(capacity, D, km.WIRES[wire]).feeds(
        iter(pieces)))
    assert [f for _, f in got] == [f for _, f in ref] == [1024, 1024, 452]
    for (g, _), (r, _) in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(
            g, r.view(np.uint16) if wire == "bf16" else r)


def test_single_superbatch_fit_equals_the_in_memory_fit(data):
    """One super-batch of the whole stream: the same sums, counts, update
    and score as ``kmeans_fit``, bit for bit."""
    x, init, _ = data
    c, obj, n = _fit(Stream(x), niter=5, init_centroids=init,
                     superbatch_rows=4096)
    ref, ref_obj = km.kmeans_fit(torch.from_numpy(x), K, 5,
                                 init_centroids=init)
    assert torch.equal(c, ref) and obj == ref_obj and n == N


@pytest.mark.parametrize("caches", [{}, {"hbm_cache_mb": 64}])
def test_resume_is_bit_equal(data, caches):
    x, init, _ = data
    ckpts = {}
    full = _fit(Stream(x), niter=5, init_centroids=init,
                checkpoint_fn=lambda it, c, o: ckpts.__setitem__(
                    it, (c.clone(), o)), **caches)
    assert sorted(ckpts) == [1, 2, 3, 4, 5]
    assert torch.equal(ckpts[5][0], full[0]) and ckpts[5][1] == full[1]
    resumed = _fit(Stream(x), niter=5, init_centroids=ckpts[2][0],
                   start_iter=2, **caches)
    _same(resumed, full)


def test_resume_argument_validation(data):
    x, init, _ = data
    with pytest.raises(ValueError, match="init_centroids"):
        _fit(Stream(x), niter=3, start_iter=1)
    with pytest.raises(ValueError, match="start_iter"):
        _fit(Stream(x), niter=3, start_iter=3, init_centroids=init)


@pytest.mark.parametrize("caches", [
    {"cache_mb": 64},
    {"hbm_cache_mb": 64},
    {"cache_spill_mb": 64},  # cache_mb 0: the cache lives on disk only
    {"cache_mb": 64, "hbm_cache_mb": 64},
])
def test_replay_is_bit_equal_and_streams_once(data, restreamed, tmp_path,
                                              caches):
    x, init, _ = data
    stream = Stream(x)
    spill = tmp_path / "spill.bin"
    got = _fit(stream, init_centroids=init, cache_spill_path=spill, **caches)
    assert stream.calls == 1
    assert not spill.exists()
    _same(got, restreamed)


def test_bf16_device_cache_replay_is_bit_equal(data):
    x, init, _ = data
    stream = Stream(x)
    cached = _fit(stream, init_centroids=init, hbm_cache_mb=64,
                  wire_dtype=torch.bfloat16)
    assert stream.calls == 1
    _same(cached, _fit(Stream(x), init_centroids=init,
                       wire_dtype=torch.bfloat16))


# a 1 MB budget against 20,000 rows x 12 f32 (0.92 MB) + one more feed
@pytest.mark.parametrize("caches,message,calls", [
    ({"hbm_cache_mb": 1}, "HBM corpus cache dropped: exceeds hbm_cache_mb=1 "
     "(falling back to re-stream)", 3),
    ({"hbm_cache_mb": 1, "cache_mb": 64}, "(falling back to host cache)", 1),
    ({"cache_mb": 1}, "stream cache dropped", 3),
    ({"cache_mb": 1, "cache_spill_mb": 64}, "stream cache spilled to disk", 1),
    ({"cache_spill_mb": 1}, "stream spill dropped", 3),
])
def test_over_budget_cache_is_dropped_logged_and_falls_back(
        tmp_path, caplog, caches, message, calls):
    x, rng = _blobs(seed=2, n=24000)
    init = x[rng.choice(len(x), K, replace=False)].copy()
    stream = Stream(x)
    spill = tmp_path / "spill.bin"
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = _fit(stream, niter=3, init_centroids=init,
                   cache_spill_path=spill, **caches)
    assert any(message in r.getMessage() for r in caplog.records)
    assert stream.calls == calls
    assert not spill.exists()
    _same(got, _fit(Stream(x), niter=3, init_centroids=init))


def test_spill_file_is_deleted_when_the_fit_fails(data, tmp_path):
    x, init, _ = data
    spill = tmp_path / "spill.bin"
    seen = []

    def stop(it, c, o):
        seen.append(spill.exists())
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _fit(Stream(x), init_centroids=init, cache_spill_path=spill,
             cache_spill_mb=64, checkpoint_fn=stop)
    assert seen == [True] and not spill.exists()


def test_ring_buffers_outlive_a_slow_consumer(data):
    """Depth 1, ring of 3: while the consumer holds a feed, its host
    buffer still holds the rows that were copied from it."""
    import time

    x, _, _ = data
    ring = km._PinnedRing(3, 256, D, torch.float32, torch.device("cpu"))
    pipe = km._FeedPipeline(km._SuperbatchFeeder(256, D),
                            Stream(x, piece=100)(), ring, depth=1)
    rows = []
    for xd, fill, buf, event in pipe:
        time.sleep(0.01)
        assert event is None and xd.shape == (fill, D)
        assert torch.equal(torch.from_numpy(buf[:fill]), xd)
        rows.append(xd)
    pipe.close()
    assert torch.equal(torch.cat(rows), torch.from_numpy(x))
    with pytest.raises(RuntimeError, match="last buffer"):
        ring.to_device(np.zeros((256, D), np.float32), 1)


@pytest.mark.parametrize("kwargs,error,match", [
    ({"d": None, "stream": []}, ValueError, "empty stream"),
    ({"stream": []}, ValueError, "empty stream"),
    ({"wire_dtype": torch.float16}, ValueError, "wire_dtype"),
    ({"precision": "high"}, None, None),
    ({"superbatch_rows": 4, "chunk": 4, "init": "random"}, ValueError,
     "first super-batch has 4 points"),
])
def test_bad_arguments_raise(data, kwargs, error, match):
    """Bad arguments raise; ``precision="high"`` (ported) runs and equals
    the in-memory fit at that tier."""
    x, _, _ = data
    pieces = kwargs.pop("stream", [x])
    kwargs.setdefault("d", D)
    if error is None:
        init = x[:K].copy()
        got, obj, _ = km.kmeans_fit_streaming(
            lambda: iter(pieces), K, 2, device="cpu", init_centroids=init,
            superbatch_rows=len(x), chunk=len(x), **kwargs)
        ref, ref_obj = km.kmeans_fit(torch.from_numpy(x), K, 2,
                                     init_centroids=init,
                                     precision=kwargs["precision"])
        assert torch.equal(got, ref) and obj == ref_obj
        return
    with pytest.raises(error, match=match):
        km.kmeans_fit_streaming(lambda: iter(pieces), K, 2, device="cpu",
                                **kwargs)


def test_kmeanspp_init_from_the_first_superbatch(data):
    """kmeans++ draws K distinct rows of the first super-batch (the port's
    draw, not the JAX package's), the same on every fit."""
    x, _, _ = data
    first = torch.from_numpy(x[:SB])
    inits = []
    for _ in range(2):
        c, _, _ = _fit(Stream(x), niter=1, init="kmeans++", seed=4)
        inits.append(c)
    assert torch.equal(inits[0], inits[1])
    want = km.kmeans_plusplus_init(first, K, seed=4, device="cpu")
    got, _, _ = _fit(Stream(x), niter=1, init_centroids=want)
    assert torch.equal(inits[0], got)


# -- the stage ---------------------------------------------------------------

STREAM = dict(kmeans_mode="full", kmeans_streaming="always",
              kmeans_superbatch_rows=1024)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A split fixture workspace with the port's spectrograms: both stages
    cluster the same .npy files."""
    base = tmp_path_factory.mktemp("kmeans_stream") / "fresh"
    fixtures.make_workspace(base, n_clips=10)
    jcfg = fixtures.test_config(base)
    DatasetSplitter(jcfg).create_split_file(AudiosetMetadataProcessor(jcfg))
    SpectrogramGenerator(port_config(base), "cpu").run()
    return base


def _copy(workspace, tmp_path, name):
    base = tmp_path / name
    shutil.copytree(workspace, base)
    return base


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_stage_matches_jax(workspace, tmp_path, wire):
    jbase = _copy(workspace, tmp_path, "jax")
    pbase = _copy(workspace, tmp_path, "port")
    jcfg = fixtures.test_config(jbase, data_parallel=1, kmeans_wire=wire,
                                **STREAM)
    pcfg = port_config(pbase, kmeans_wire=wire, **STREAM)
    ref = JaxClusterCreator(jcfg).run()
    got = ClusterCreator(pcfg, "cpu").run()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_array_equal(np.load(pcfg.centroids_path), got)


def test_stage_signature_and_init_equal_jax(workspace):
    for wire in ("f32", "bf16"):
        jcc = JaxClusterCreator(fixtures.test_config(
            workspace, data_parallel=1, kmeans_wire=wire, **STREAM))
        pcc = ClusterCreator(port_config(workspace, kmeans_wire=wire,
                                         **STREAM), "cpu")
        assert pcc._stream_signature() == jcc._stream_signature()
    ref = jcc._global_init_centroids()
    got = pcc._global_init_centroids()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


class Interrupt(Exception):
    pass


def _interrupted(cfg, after):
    """A stage whose fit is stopped once its checkpoint of iteration
    ``after`` is written."""
    cc = ClusterCreator(cfg, "cpu")
    save = cc._save_kmeans_checkpoint

    def save_then_stop(it, c, o):
        save(it, c, o)
        if it == after:
            raise Interrupt

    cc._save_kmeans_checkpoint = save_then_stop
    with pytest.raises(Interrupt):
        cc.run()
    return cc


def test_stage_checkpoint_is_resumed_then_deleted(workspace, tmp_path):
    base = _copy(workspace, tmp_path, "ws")
    cfg = port_config(base, incremental=True, **STREAM)
    full = ClusterCreator(cfg, "cpu").run()
    cc = _interrupted(cfg, after=2)
    ckpt = np.load(cc._kmeans_ckpt_path())
    assert int(ckpt["iter"]) == 2 and set(ckpt.files) == {
        "centroids", "iter", "obj", "signature"}
    assert str(ckpt["signature"]) == cc._stream_signature()
    resumed = ClusterCreator(cfg, "cpu")
    np.testing.assert_array_equal(resumed.run(), full)
    assert not resumed._kmeans_ckpt_path().exists()


def test_stage_rerun_without_incremental_deletes_the_checkpoint(
        workspace, tmp_path, monkeypatch):
    base = _copy(workspace, tmp_path, "ws")
    cfg = port_config(base, **STREAM)
    full = ClusterCreator(cfg, "cpu").run()
    cc = _interrupted(cfg, after=3)
    path = cc._kmeans_ckpt_path()
    assert path.exists()
    starts = []
    fit = km.kmeans_fit_streaming

    def spy(*args, **kwargs):
        starts.append(kwargs["start_iter"])
        return fit(*args, **kwargs)

    monkeypatch.setattr(
        "audio_tokens_tpu_torch.processors.cluster_creator."
        "kmeans_fit_streaming", spy)
    np.testing.assert_array_equal(ClusterCreator(cfg, "cpu").run(), full)
    assert starts == [0] and not path.exists()


def test_stage_complete_checkpoint_skips_the_fit(workspace, tmp_path,
                                                 monkeypatch):
    base = _copy(workspace, tmp_path, "ws")
    cfg = port_config(base, incremental=True, **STREAM)
    cc = ClusterCreator(cfg, "cpu")
    planted = np.random.default_rng(1).standard_normal(
        (cfg.vocab_size, cfg.feature_dim)).astype(np.float32)
    cc._save_kmeans_checkpoint(cfg.niter, torch.from_numpy(planted), 1.0)

    def no_fit(*args, **kwargs):
        raise AssertionError("the fit ran")

    monkeypatch.setattr(
        "audio_tokens_tpu_torch.processors.cluster_creator."
        "kmeans_fit_streaming", no_fit)
    got = ClusterCreator(cfg, "cpu").run()
    np.testing.assert_allclose(
        got, planted / (np.linalg.norm(planted, axis=1, keepdims=True)
                        + 1e-10), atol=1e-7, rtol=0)
    assert not cc._kmeans_ckpt_path().exists()


def test_stage_spills_to_the_output_dir_and_warns(workspace, tmp_path,
                                                  caplog):
    base = _copy(workspace, tmp_path, "ws")
    cfg = port_config(base, kmeans_stream_spill_mb=64,
                      max_points_per_centroid=64, **STREAM)
    ref = port_config(_copy(workspace, tmp_path, "ref"), **STREAM)
    with caplog.at_level(logging.INFO):
        got = ClusterCreator(cfg, "cpu").run()
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "max_points_per_centroid=64 is ignored" in text
    spill = base / "output" / "kmeans_stream_spill.p0.bin"
    assert f"stream cache spilled to disk: {spill}" in text
    assert not spill.exists()
    np.testing.assert_array_equal(got, ClusterCreator(ref, "cpu").run())


def test_stage_refuses_an_unknown_wire(workspace, tmp_path):
    cfg = port_config(_copy(workspace, tmp_path, "ws"), kmeans_wire="f16",
                      **STREAM)
    with pytest.raises(ValueError, match="kmeans_wire must be"):
        ClusterCreator(cfg, "cpu").run()
