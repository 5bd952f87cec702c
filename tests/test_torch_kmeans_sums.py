"""The K-means centroid sums (``audio_tokens_tpu_torch/ops/cuda_kmeans.py``)
on the CPU: the kernel's decomposition rendered in plain PyTorch
(``sums_decomposition``: tiles of sorted positions, a sequential f64 sum a
run, each cluster's runs added in order) and the plain version
(``tier_sums64_plain``) against per-cluster f64 numpy sums of the tier's
parts, and the fit at each precision against the JAX package's fit.

Tolerances: the three sum the same f32 parts in f64 in different orders,
so each entry is held within 1e-12 of the sum of its |parts| (f64 carries
53 bits; a few hundred additions lose far less than 1e-12 of it).  The
tier's parts themselves are held exactly: hi = bf16(x), lo = bf16(x - hi),
round to nearest even.
"""

import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops import kmeans as jax_km
from audio_tokens_tpu_torch.ops import kmeans as km
from audio_tokens_tpu_torch.ops.cuda_kmeans import (
    sums_decomposition,
    tier_sums64,
    tier_sums64_plain,
)

F64_TOL = 1e-12


def _bf16(a: np.ndarray) -> np.ndarray:
    """a (f32) rounded to bf16, nearest even, as f32 (numpy bit ops)."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32)


def _np_parts(x: np.ndarray, tier: str):
    if tier == "highest":
        return [x]
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if tier == "bf16x3" else [hi]


def _np_sums(x, ids, k, tier):
    """(parts, K, d) f64 per-cluster sums and sums of |part|, in numpy."""
    parts = _np_parts(x, tier)
    sums = np.zeros((len(parts), k, x.shape[1]))
    mags = np.zeros_like(sums)
    for p, part in enumerate(parts):
        np.add.at(sums[p], ids, part.astype(np.float64))
        np.add.at(mags[p], ids, np.abs(part).astype(np.float64))
    return sums, mags


def _case(n, d, k, seed, empty=()):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 10.0).astype(np.float32)
    ids = rng.integers(0, k, n).astype(np.int32)
    keep = min(set(range(k)) - set(empty))
    ids[np.isin(ids, empty)] = keep
    return x, ids


# (n, d, k, tile, empty clusters): runs that span many tiles (tile 8), a
# partial last tile (n not a multiple of the tile), a single partial tile,
# one row, empty clusters, the tile equal to n, K 16,384 at d 640 on a few
# hundred rows (most clusters empty), d 128 and d past a multiple of 64
SUM_CASES = [
    (200, 6, 5, 8, (2,)),
    (203, 64, 9, 16, (0, 8)),
    (17, 64, 9, 256, (4,)),
    (1, 3, 2, 256, ()),
    (256, 128, 30, 256, (7,)),
    (300, 640, 16384, 64, ()),
    (777, 130, 40, 32, (39,)),
]


@pytest.mark.parametrize("tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("n,d,k,tile,empty", SUM_CASES)
def test_decomposition_equals_per_cluster_sums(n, d, k, tile, empty, tier):
    x, ids = _case(n, d, k, n + d + k, empty)
    got = sums_decomposition(torch.from_numpy(x), torch.from_numpy(ids), k,
                             tier, tile).numpy()
    ref, mags = _np_sums(x, ids, k, tier)
    assert got.shape == ref.shape == ((2 if tier == "bf16x3" else 1), k, d)
    assert np.all(np.abs(got - ref) <= F64_TOL * mags)
    for c in empty:
        assert (got[:, c] == 0).all()


@pytest.mark.parametrize("tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("n,d,k,tile,empty", SUM_CASES)
def test_plain_sums_equal_the_decomposition(n, d, k, tile, empty, tier):
    """The CPU path (``tier_sums64`` on CPU tensors: the plain version, the
    card's kernel held to it) against the kernel's decomposition."""
    x, ids = _case(n, d, k, 3 * n + d, empty)
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    plain = tier_sums64(xt, it, k, tier, tile)
    assert torch.equal(plain, tier_sums64_plain(xt, it, k, tier, tile))
    dec = sums_decomposition(xt, it, k, tier, tile)
    _, mags = _np_sums(x, ids, k, tier)
    assert np.all(np.abs((plain - dec).numpy()) <= F64_TOL * mags)


def test_sums_of_no_rows_are_zero():
    for tier, parts in (("highest", 1), ("bf16x3", 2), ("default", 1)):
        out = tier_sums64(torch.zeros((0, 5)), torch.zeros(0, dtype=torch.int32),
                          3, tier)
        assert out.shape == (parts, 3, 5) and (out == 0).all()


def test_bf16x3_parts_are_the_split():
    """At bf16x3 the two parts are hi(x) and lo(x) apart, their sum within
    the split's error of x's own sum; at default the part is bf16(x)."""
    x, ids = _case(500, 64, 7, 5)
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    hi_lo = tier_sums64(xt, it, 7, "bf16x3")
    dflt = tier_sums64(xt, it, 7, "default")
    exact = tier_sums64(xt, it, 7, "highest")[0]
    assert torch.equal(hi_lo[0], dflt[0])
    _, mags = _np_sums(x, ids, 7, "highest")
    assert np.all(np.abs((hi_lo.sum(0) - exact).numpy())
                  <= 2.0 ** -16 * mags[0] + 1e-12)
    assert not torch.equal(hi_lo.sum(0), exact)


# the fit at each precision against the JAX package's (highest on the CPU,
# where XLA computes every precision in f32): well-separated blobs, the
# same assignments at highest and bf16x3, so the centroids agree up to the
# rows' rounding (f32 sums in another order: 1e-5; bf16x3's ~16 bits:
# 1e-4); default's 8 bits move rows, so its objective is held within 1%
FIT_TOL = {"highest": (1e-5, 1e-5), "high": (1e-4, 1e-5),
           "default": (None, 1e-2)}


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fit_at_each_precision_matches_jax(precision):
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((8, 16)) * 2.0
    x = (centers[rng.integers(0, 8, 4096)]
         + rng.standard_normal((4096, 16))).astype(np.float32)
    init = x[rng.choice(len(x), 8, replace=False)]
    jc, jobj = jax_km.kmeans_fit(x, 8, 8, init_centroids=init)
    pc, pobj = km.kmeans_fit(torch.from_numpy(x), 8, 8, init_centroids=init,
                             precision=precision)
    cent_tol, obj_tol = FIT_TOL[precision]
    if cent_tol is not None:
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=cent_tol,
                                   rtol=0)
    assert abs(pobj - jobj) <= obj_tol * abs(jobj)
