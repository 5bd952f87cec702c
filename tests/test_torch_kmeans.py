"""The port's K-means (``audio_tokens_tpu_torch/ops/kmeans.py``) against the
JAX package's on the CPU, numpy inputs from a seed.

Tolerances: both sides sum in f32 in different orders (the JAX scan pads to
a power-of-two count of chunks; the port adds one-hot GEMMs of its own
chunk size), so whole fits are held within 1e-5 only on well-separated
data, and on unclustered data one Lloyd step is held: assignments under the
near-tie rule (``ops/vq.check_near_ties``), centroids within 1e-5 where the
two assignments agree.  Random draws (subsample, init) and the empty-cluster
repair are held exactly."""

import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops import kmeans as jax_km
from audio_tokens_tpu.ops import vq as jax_vq
from audio_tokens_tpu_torch.ops import kmeans as km
from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin
from audio_tokens_tpu_torch.ops.vq import check_near_ties

TOL = 1e-5


def _blobs(seed=0, n=4096, d=16, k=8, spread=2.0):
    """Gaussian blobs: unit-variance clusters around centers of scale
    ``spread`` per dimension (centers ~8 apart, clusters ~4 wide)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    x = centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))
    return x.astype(np.float32), rng


def _unit_noise(seed=1, n=4096, d=16):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _fit(x, k, niter, **kw):
    c, obj = km.kmeans_fit(torch.from_numpy(x), k, niter, **kw)
    assert c.device.type == "cpu" and c.dtype == torch.float32
    return c.numpy(), obj


@pytest.mark.parametrize("empty_policy", ["keep", "split_largest"])
def test_fit_on_blobs_matches_jax(empty_policy):
    x, rng = _blobs()
    init = x[rng.choice(len(x), 8, replace=False)]
    jc, jobj = jax_km.kmeans_fit(x, 8, 10, init_centroids=init,
                                 empty_policy=empty_policy)
    pc, pobj = _fit(x, 8, 10, init_centroids=init, empty_policy=empty_policy)
    np.testing.assert_allclose(pc, jc, atol=TOL, rtol=0)
    assert abs(pobj - jobj) <= TOL * abs(jobj)


def test_one_lloyd_step_on_unclustered_data_matches_jax():
    x = _unit_noise()
    init = x[:64].copy()
    ids_jax = torch.from_numpy(np.array(jax_vq.vq_assign(x, init)))
    ids = km.assign(torch.from_numpy(x), torch.from_numpy(init))
    check_near_ties(torch.from_numpy(x), torch.from_numpy(init), ids, ids_jax)
    jc, jobj = jax_km.kmeans_fit(x, 64, 1, init_centroids=init)
    pc, pobj = _fit(x, 64, 1, init_centroids=init)
    # clusters whose members are the same in both assignments
    moved = set(ids[ids != ids_jax].tolist()) | set(
        ids_jax[ids != ids_jax].tolist())
    same = [c for c in range(64) if c not in moved]
    assert len(same) >= 60
    np.testing.assert_allclose(pc[same], jc[same], atol=TOL, rtol=0)
    assert abs(pobj - jobj) <= TOL * abs(jobj)


@pytest.mark.parametrize("mppc", [None, 100])
def test_random_init_and_subsample_draw_the_jax_rows(mppc):
    """niter 0 returns the init itself: the same rows of the same
    subsample as the JAX package's numpy draws."""
    x, _ = _blobs(seed=4)
    jc, jobj = jax_km.kmeans_fit(x, 8, 0, seed=5, max_points_per_centroid=mppc)
    pc, pobj = _fit(x, 8, 0, seed=5, max_points_per_centroid=mppc)
    np.testing.assert_array_equal(pc, jc)
    assert pobj == jobj == 0.0


def test_subsampled_fit_matches_jax():
    x, _ = _blobs(seed=6)
    jc, jobj = jax_km.kmeans_fit(x, 8, 6, seed=2, max_points_per_centroid=64)
    pc, pobj = _fit(x, 8, 6, seed=2, max_points_per_centroid=64)
    np.testing.assert_allclose(pc, jc, atol=TOL, rtol=0)
    assert abs(pobj - jobj) <= TOL * abs(jobj)


def test_warm_start_class_matches_jax():
    """train(batch0) then train(batch1, init_centroids=centroids)."""
    x, _ = _blobs(seed=7, n=6000)
    batches = (x[:3000], x[3000:])
    jk = jax_km.KMeans(16, 8, niter=5, seed=3)
    pk = km.KMeans(16, 8, niter=5, seed=3, device="cpu")
    for i, b in enumerate(batches):
        jobj = jk.train(b) if i == 0 else jk.train(
            b, init_centroids=jk.centroids)
        pobj = pk.train(b) if i == 0 else pk.train(
            b, init_centroids=pk.centroids)
        np.testing.assert_allclose(pk.centroids.numpy(), jk.centroids,
                                   atol=TOL, rtol=0)
        assert abs(pobj - jobj) <= TOL * abs(jobj)
        assert pk.obj == pobj


def test_split_empty_clusters_equals_jax_exactly():
    rng = np.random.default_rng(8)
    cents = rng.standard_normal((9, 7)).astype(np.float32)
    counts = np.array([5, 0, 12, 0, 12, 3, 0, 1, 0], np.float32)
    jc, jn = jax_km._split_empty_clusters(cents, counts)
    pc, pn = km._split_empty_clusters(torch.from_numpy(cents),
                                      torch.from_numpy(counts))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    # no empty cluster: returned unchanged
    full = torch.ones(9)
    assert km._split_empty_clusters(torch.from_numpy(cents), full)[1] is full


@pytest.mark.parametrize("empty_policy", ["keep", "split_largest"])
def test_empty_cluster_policies_match_jax(empty_policy):
    """An init centroid far from every point stays empty: "keep" keeps it
    bit for bit, "split_largest" repairs it as the JAX package does."""
    x, rng = _blobs(seed=9, n=2048, k=4)
    init = x[rng.choice(len(x), 5, replace=False)].copy()
    init[2] = 1e3
    jc, jobj = jax_km.kmeans_fit(x, 5, 3, init_centroids=init,
                                 empty_policy=empty_policy)
    pc, pobj = _fit(x, 5, 3, init_centroids=init, empty_policy=empty_policy)
    np.testing.assert_allclose(pc, jc, atol=TOL, rtol=0)
    assert abs(pobj - jobj) <= TOL * abs(jobj)
    if empty_policy == "keep":
        np.testing.assert_array_equal(pc[2], init[2])
    else:
        assert np.abs(pc[2]).max() < 100.0


def test_lloyd_stats_objective_is_the_assignment_score():
    """The per-cluster objective equals the per-row sum of the assigned
    scores (float64 reference)."""
    x = _unit_noise(seed=10, n=3000, d=8)
    c = x[:20].copy()
    sums, counts, score = km._lloyd_stats(torch.from_numpy(x),
                                          torch.from_numpy(c))
    xd, cd = x.astype(np.float64), c.astype(np.float64)
    s = (cd * cd).sum(1)[None, :] - 2.0 * xd @ cd.T
    ids = s.argmin(1)
    assert abs(float(score) - s.min(1).sum()) <= 1e-9 * np.abs(s).sum()
    np.testing.assert_array_equal(counts.numpy(), np.bincount(ids,
                                                              minlength=20))
    ref = np.stack([xd[ids == j].sum(0) for j in range(20)])
    np.testing.assert_allclose(sums.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,block", [(5, 256), (256, 256), (1000, 256),
                                     (1000, 4), (999, 1)])
def test_cluster_sums_equal_the_per_cluster_sums(n, block):
    """Sorted-row sums against float64 per-cluster sums: runs that span
    blocks, a partial last block, empty clusters, one-row blocks."""
    rng = np.random.default_rng(n + block)
    x = rng.standard_normal((n, 6)).astype(np.float32) * 10.0
    ids = rng.integers(0, 9, n).astype(np.int32)
    ids[ids == 4] = 5  # cluster 4 stays empty
    sums, counts = km.cluster_sums(torch.from_numpy(x),
                                   torch.from_numpy(ids), 11, block=block)
    ref = np.stack([x[ids == j].astype(np.float64).sum(0) for j in
                    range(11)])
    np.testing.assert_allclose(sums.numpy(), ref, atol=2e-5, rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=11))
    assert counts[4] == 0 and (sums[4] == 0).all()


def test_fit_assigns_once_an_iteration(monkeypatch):
    """One call of B2's wrapper with ``normalize=False`` an iteration; on
    the CPU it takes the plain version, so the launch count stays."""
    x, _ = _blobs(seed=11, n=1000)
    calls = []

    def spy(frames, centroids, normalize):
        calls.append(normalize)
        return vq_argmin(frames, centroids, normalize)

    monkeypatch.setattr(km, "vq_argmin", spy)
    before = vq_argmin.launches
    _fit(x, 8, 7, seed=1)
    assert calls == [False] * 7
    assert vq_argmin.launches == before


def test_kmeanspp_picks_distinct_rows_deterministically():
    x, _ = _blobs(seed=12, n=3000)
    xt = torch.from_numpy(x)
    a = km.kmeans_plusplus_init(xt, 16, seed=3)
    b = km.kmeans_plusplus_init(xt, 16, seed=3)
    c = km.kmeans_plusplus_init(xt, 16, seed=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    rows = {tuple(r) for r in a.tolist()}
    assert len(rows) == 16 and rows <= {tuple(r) for r in x.tolist()}


def test_kmeanspp_draws_by_squared_distance():
    """Rows at distance 0 from a chosen row are never drawn (k distinct
    points among duplicates), and a far outlier is drawn."""
    rng = np.random.default_rng(13)
    distinct = rng.standard_normal((6, 5)).astype(np.float32)
    dup = np.repeat(distinct, 50, axis=0)
    got = km.kmeans_plusplus_init(torch.from_numpy(dup), 6, seed=0)
    assert {tuple(r) for r in got.tolist()} == {tuple(r) for r in
                                               distinct.tolist()}
    blob = rng.standard_normal((2000, 5)).astype(np.float32) * 0.01
    blob[777] = 100.0
    for seed in range(5):
        got = km.kmeans_plusplus_init(torch.from_numpy(blob), 2, seed=seed)
        assert (got == 100.0).all(1).any()


def test_kmeanspp_init_through_the_fit():
    x, _ = _blobs(seed=14)
    c0 = km.kmeans_plusplus_init(torch.from_numpy(x), 8, seed=5)
    pc, _ = _fit(x, 8, 0, seed=5, init="kmeans++")
    np.testing.assert_array_equal(pc, c0.numpy())


@pytest.mark.parametrize("kwargs,error", [
    ({"precision": "high"}, NotImplementedError),
    ({"precision": "default"}, NotImplementedError),
    ({"precision": "fastest"}, ValueError),
    ({"init": "kmeans||"}, ValueError),
    ({"empty_policy": "drop"}, ValueError),
])
def test_unported_or_unknown_options_raise(kwargs, error):
    x, _ = _blobs(seed=15, n=200)
    match = "ROADMAP A6" if error is NotImplementedError else None
    with pytest.raises(error, match=match):
        km.kmeans_fit(torch.from_numpy(x), 8, 2, **kwargs)


def test_too_few_points_raise():
    x = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError, match="k=8"):
        km.kmeans_fit(x, 8, 1, device="cpu")
    with pytest.raises(ValueError, match="k=8"):
        km.kmeans_plusplus_init(x, 8, device="cpu")


def test_numpy_points_go_to_the_given_device():
    x, _ = _blobs(seed=16, n=500)
    c, _ = km.kmeans_fit(x.astype(np.float64), 8, 2, device="cpu")
    assert c.device.type == "cpu" and c.dtype == torch.float32
