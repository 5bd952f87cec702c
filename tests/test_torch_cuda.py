"""On a CUDA card only: each hand-written kernel of the port against its
plain PyTorch version.  Without a card every test here skips.

This file imports neither jax nor the JAX package, so on a machine with a
card and no jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    from audio_tokens_tpu_torch.ops.common import exact_f32

    exact_f32()
    return torch.device("cuda", 0)


# B2's shapes: K 1, 500 (centroids resident in shared memory where d is
# narrow) and 16,384 (streamed through the ring); d 10 (4-byte copies), 12,
# 32 and 64; d 100 (the widest whole-row ring) and 128, 130 and 256 (walked
# in feature slices, 130 with 4-byte copies and slices of 44); K 300 at d 32;
# N not a multiple of the 128-row frame tile
VQ_SHAPES = ([(k, d) for k in (1, 500, 16384) for d in (10, 12, 32, 64)]
             + [(300, 32)]
             + [(k, d) for k in (500, 16384) for d in (100, 128, 130, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("k,d", VQ_SHAPES)
def test_cuda_vq_kernel_matches_plain(cuda_device, k, d, normalize):
    """B2 against its plain version under the near-tie rule."""
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    rng = np.random.default_rng(k + d)
    x = torch.from_numpy(rng.standard_normal((3001, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    x, c = x.to(cuda_device), c.to(cuda_device)
    before = vq_argmin.launches
    got = vq_argmin(x, c, normalize)
    assert vq_argmin.launches == before + 1
    ref = vq_argmin_plain(x, c, normalize)
    check_near_ties(l2_normalize(x) if normalize else x, c, got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k,dups", [(500, (3, 19, 130, 499)),
                                    (16384, (5, 21, 8000, 16383))])
def test_cuda_vq_duplicated_centroids_take_the_lowest_index(cuda_device, k,
                                                            dups):
    """Equal centroids in one lane, in other lanes and in other chunks give
    equal scores: the lowest index wins, as in the plain version."""
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain

    rng = np.random.default_rng(k)
    c = rng.standard_normal((k, 64)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)  # a unit vocabulary
    c[list(dups)] = c[dups[0]]
    x = rng.standard_normal((1000, 64)).astype(np.float32)
    near = np.arange(0, 1000, 7)
    x[near] = c[dups[0]] + 1e-3 * x[near]  # nearest: the duplicated rows
    x[::13] = c[dups[0]]  # exactly on them
    x, c = torch.from_numpy(x).to(cuda_device), torch.from_numpy(c).to(
        cuda_device)
    for normalize in (False, True):
        got = vq_argmin(x, c, normalize).cpu()
        ref = vq_argmin_plain(x, c, normalize).cpu()
        assert (ref[near] == dups[0]).all() and (ref[::13] == dups[0]).all()
        assert (got[near] == dups[0]).all() and (got[::13] == dups[0]).all()


@pytest.mark.cuda
def test_cuda_tokenizer_kernel_matches_plain(cuda_device):
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    rng = np.random.default_rng(0)
    cents = rng.standard_normal((300, 32)).astype(np.float32)
    fe = MelFrontend("cpu", 22050, 32, 256, 128, int(22050 * 1.5))
    kern = TokenizerKernel(22050, 32, 256, 128, fe.frames_max, cents,
                           cuda_device)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.4, 0.9, 1.5)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(cuda_device)
    before = TokenizerKernel.launches
    got = kern(x)
    assert TokenizerKernel.launches == before + 1
    check_near_ties(l2_normalize(kern.log_mel_plain(x)), kern.centroids,
                    got, kern.plain(x))


# (n_fft, hop, n_mels, K): 1.5 s clips give 259 frames at hop 128 and 130 at
# hop 256, a ragged last tile either way.  B1 takes 128-frame blocks unless
# their shared memory would pass 227 KB: hop 256 (a 32 K-sample window) at
# n_fft 256 or 512 takes 64-frame blocks, the other cases 128.  n_fft 200
# pads the basis to 208 rows and 128 bins; hop 126 loads the window 4 bytes
# at a time
TOKENIZER_CASES = [
    (512, 128, 64, 300),
    (512, 256, 64, 300),
    (256, 128, 32, 300),
    (256, 256, 32, 300),
    (512, 256, 64, 1),
    (256, 128, 32, 1),
    (512, 256, 64, 16384),
    (512, 128, 64, 16384),
    (200, 100, 32, 300),
    (256, 126, 32, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,n_mels,k", TOKENIZER_CASES)
def test_cuda_tokenizer_tiles_match_plain(cuda_device, n_fft, hop, n_mels,
                                          k):
    """B1 at both frame tiles, each with a ragged last tile, at K 1 and
    16,384, n_fft 200, 256 and 512, and an odd-multiple hop: tokens within
    the near-tie rule of the plain version; rows longer than padded_len
    give the same tokens."""
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    rng = np.random.default_rng(k)
    cents = rng.standard_normal((k, n_mels)).astype(np.float32)
    fe = MelFrontend("cpu", 22050, n_mels, n_fft, hop, int(22050 * 1.5))
    assert fe.frames_max % 64 and fe.frames_max % 128
    kern = TokenizerKernel(22050, n_mels, n_fft, hop, fe.frames_max, cents,
                           cuda_device)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.5, 0.7, 1.2)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(cuda_device)
    before = TokenizerKernel.launches
    got = kern(x)
    assert TokenizerKernel.launches == before + 1
    check_near_ties(l2_normalize(kern.log_mel_plain(x)), kern.centroids,
                    got, kern.plain(x))
    wide = torch.cat([x, torch.full((x.shape[0], 37), 1e3,
                                    device=cuda_device)], 1)
    assert torch.equal(kern(wide), got)


# B2 at the bf16 tiers (csrc/vq.cu's wgmma instance): K 1, 300 and 500 (the
# Lloyd assignment's), d 10 (cp.async rows), 32, 64 and 100; the shapes the
# mma.sync design refused: K 545 and 1,089 (past what stays resident at
# bf16x3 and default; not multiples of the 128-wide chunk), 16,384 (the
# ring), d 128 (8 k-steps of fragments) and 640 (feature slices); K 1,100 at
# d 100 (64-wide chunks, a partial last one)
VQ_TIER_SHAPES = [(1, 10), (300, 32), (500, 64), (500, 12), (100, 100),
                  (545, 64), (1089, 64), (16384, 64), (500, 128), (500, 640),
                  (1100, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("k,d", VQ_TIER_SHAPES)
def test_cuda_vq_tier_matches_plain(cuda_device, k, d, normalize, tier):
    """B2 on the tensor cores against its plain tier version under the
    tier's near-tie rule, and to its tier against the f32 kernel: where the
    plain tier version leaves the highest answer, the kernel follows it.
    At default on the raw rows (K > 1) there are always such rows here;
    normalized rows against these unnormalized centroids are decided
    mostly by ||c||^2, and may leave too few."""
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.tiers import (check_follows_tier,
                                                  check_tier_ties)
    from audio_tokens_tpu_torch.ops.vq import l2_normalize

    rng = np.random.default_rng(k + d + 1)
    x = torch.from_numpy(rng.standard_normal((30001, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    x, c = x.to(cuda_device), c.to(cuda_device)
    before = vq_argmin.launches
    got = vq_argmin(x, c, normalize, tier)
    assert vq_argmin.launches == before + 1
    ref = vq_argmin_plain(x, c, normalize, tier=tier)
    check_tier_ties(l2_normalize(x) if normalize else x, c, got, ref, tier)
    highest = vq_argmin(x, c, normalize)
    _, followed = check_follows_tier(got, ref, highest, tier, min_rows=20,
                                     band=False)
    if tier == "default" and k > 1 and not normalize:
        assert followed is not None


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("k", [500, 16384])
def test_cuda_vq_tier_duplicated_centroids_take_the_lowest_index(cuda_device,
                                                                 k, tier):
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin

    rng = np.random.default_rng(5)
    c = rng.standard_normal((k, 64)).astype(np.float32)
    dups = (3, 19, 130, k - 1)
    c[list(dups)] = c[dups[0]]
    x = rng.standard_normal((1000, 64)).astype(np.float32)
    x[::13] = c[dups[0]]
    got = vq_argmin(torch.from_numpy(x).to(cuda_device),
                    torch.from_numpy(c).to(cuda_device), False, tier).cpu()
    assert (got[::13] == dups[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("k,d", [(16384, 64), (500, 130)])
def test_cuda_vq_tier_takes_what_the_resident_design_refused(cuda_device, k,
                                                             d, tier):
    """The shapes the mma.sync design refused with ValueError launch once
    and hold to their plain tier version (d 130: rows of 520 bytes, copied
    4 bytes at a time; a view off 16-byte alignment)."""
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.tiers import check_tier_ties

    rng = np.random.default_rng(k + d)
    x = torch.from_numpy(rng.standard_normal((5001, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    x = x.to(cuda_device)[1:]
    c = c.to(cuda_device)
    before = vq_argmin.launches
    got = vq_argmin(x, c, False, tier)
    assert vq_argmin.launches == before + 1
    check_tier_ties(x, c, got, vq_argmin_plain(x, c, False, tier=tier), tier)


# (K, d) of the plan test: the CPU tests' grid (tests/test_torch_tiers.py)
TIER_PLAN_SHAPES = [(k, d) for k in (1, 500, 1100, 16384)
                    for d in (12, 64, 100, 128, 130, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_cuda_vq_tier_plan_is_the_c_plan(cuda_device, tier):
    """ops/cuda_vq.vq_tier_plan (by which the wrapper lays out the image)
    equals csrc/vq.cu's tier_plan (by which the kernel reads it)."""
    import ctypes
    import dataclasses

    from audio_tokens_tpu_torch.ops.cuda_vq import _lib, vq_tier_plan

    lib = _lib()
    for k, d in TIER_PLAN_SHAPES:
        plan = vq_tier_plan(k, d, tier)
        out = (ctypes.c_int * len(dataclasses.fields(plan)))()
        assert lib.atk_vq_tier_plan(d, k, int(tier == "bf16x3"), out) == 0
        assert list(out) == list(dataclasses.astuple(plan)), (k, d)


# the K-means objective's drift a tier's fit may show (chip_smoke.py's
# KMEANS_DRIFT, there against the highest fit)
KMEANS_DRIFT = {"high": 1e-6, "default": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("k,d", [(1100, 64), (64, 640)])
def test_cuda_kmeans_tier_fit_matches_the_plain_fit(cuda_device, k, d,
                                                    precision):
    """KMeans.train at the tier on the card (B2) against the same fit on
    the CPU (the plain tier version): the objectives within KMEANS_DRIFT."""
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin

    rng = np.random.default_rng(k + d)
    centers = rng.standard_normal((k, d)) * 2.0
    x = (centers[rng.integers(0, k, 100_000)]
         + rng.standard_normal((100_000, d))).astype(np.float32)
    init = x[rng.choice(len(x), k, replace=False)].copy()
    card = km.KMeans(d, k, niter=5, precision=precision, device=cuda_device)
    before = vq_argmin.launches
    card_obj = card.train(x, init_centroids=init)
    assert vq_argmin.launches == before + 5
    cpu = km.KMeans(d, k, niter=5, precision=precision, device="cpu")
    cpu_obj = cpu.train(x, init_centroids=init)
    assert np.isfinite(card_obj)
    assert abs(card_obj - cpu_obj) <= KMEANS_DRIFT[precision] * abs(cpu_obj)


# the centroid sums kernel's shapes (N, d, K): 17 rows and K 9 (one partial
# tile), runs spanning tiles at d 64 and K 500, K 16,384 (most clusters in
# one tile, many empty), d 128 and the conv front-end's d 640, d 130 (a
# partial 64-column slab)
SUMS_SHAPES = [(17, 64, 9), (200_001, 64, 500), (40_000, 64, 16384),
               (30_000, 128, 500), (6_000, 640, 500), (5_000, 130, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("n,d,k", SUMS_SHAPES)
def test_cuda_tier_sums_match_plain(cuda_device, n, d, k, tier):
    """``tier_sums64`` on the card (csrc/kmeans.cu) against its plain
    version on the same card tensors: f64 within 1e-12 of the entry's sum of
    |parts| (another order of the same f64 additions), the f32 roundings
    equal on all but 1e-4 of the entries and at most 1 ulp apart; one
    launch; and bit for bit the kernel's decomposition rendered in plain
    PyTorch where it is small enough to run."""
    from audio_tokens_tpu_torch.ops.cuda_kmeans import (sums_decomposition,
                                                        tier_sums64,
                                                        tier_sums64_plain)
    from audio_tokens_tpu_torch.ops.tiers import tier_operands

    rng = np.random.default_rng(n + d + k)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                         ).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)
                           ).to(cuda_device)
    before = tier_sums64.launches
    got = tier_sums64(x, ids, k, tier)
    assert tier_sums64.launches == before + 1
    ref = tier_sums64_plain(x, ids, k, tier)
    assert got.shape == ref.shape
    mags = torch.stack([tier_sums64_plain(p.abs(), ids, k, "highest")[0]
                        for p in tier_operands(x, tier)])
    assert bool(((got - ref).abs() <= 1e-12 * mags).all())
    g32, r32 = got.float(), ref.float()
    apart = g32 != r32
    assert float(apart.float().mean()) <= 1e-4
    ulps = (g32.view(torch.int32).long() - r32.view(torch.int32).long()).abs()
    assert not apart.any() or int(ulps[apart].max()) <= 1
    if n * d <= 200_000:
        assert torch.equal(got, sums_decomposition(x, ids, k, tier))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cuda_kmeans_tier_fits_are_bit_equal_through_the_sums_kernel(
        cuda_device, precision):
    """Two fits of the same points on the card at each precision give the
    same bits, the sums kernel launched once an iteration; a streaming fit
    of one super-batch equals ``kmeans_fit`` bit for bit."""
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_kmeans import tier_sums64

    x = _unit_rows(120_003, 64, 9).to(cuda_device)
    init = x[:300].clone()
    fits = []
    for _ in range(2):
        before = tier_sums64.launches
        fits.append(km.kmeans_fit(x, 300, 5, init_centroids=init,
                                  precision=precision))
        assert tier_sums64.launches == before + 5
    assert torch.equal(fits[0][0], fits[1][0]) and fits[0][1] == fits[1][1]
    host = x.cpu().numpy()
    sc, sobj, seen = km.kmeans_fit_streaming(
        lambda: iter([host[:60_000], host[60_000:]]), 300, 5, d=64,
        init_centroids=init, superbatch_rows=1 << 17, chunk=1 << 15,
        precision=precision, device=cuda_device)
    assert seen == x.shape[0]
    assert torch.equal(sc, fits[0][0]) and sobj == fits[0][1]


# (tier, vq_tier): every combination with a bf16 tier
TOKENIZER_TIERS =[(t, v) for t in ("highest", "bf16x3", "default")
                   for v in ("highest", "bf16x3", "default")
                   if (t, v) != ("highest", "highest")]
# (n_fft, hop, n_mels, K): the package defaults at K 500 and 16,384, a
# narrow case with K 300 (chunks of 64 centroids, a partial last one) and a
# 64-frame f32 tile (hop 256 at n_fft 512)
TOKENIZER_TIER_CASES = [(512, 128, 64, 500), (512, 128, 64, 16384),
                        (256, 128, 32, 300), (512, 256, 64, 300),
                        (512, 128, 64, 16383)]


@pytest.mark.cuda
@pytest.mark.parametrize("tier,vq_tier", TOKENIZER_TIERS)
@pytest.mark.parametrize("n_fft,hop,n_mels,k", TOKENIZER_TIER_CASES)
def test_cuda_tokenizer_tiers_match_plain(cuda_device, n_fft, hop, n_mels, k,
                                          tier, vq_tier):
    """B1 at each tier combination against its plain tier version, under
    the near-tie rule of the coarser of the two tiers."""
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.tiers import (check_follows_tier,
                                                  check_tier_ties)
    from audio_tokens_tpu_torch.ops.vq import l2_normalize

    rng = np.random.default_rng(k + n_mels)
    cents = rng.standard_normal((k, n_mels)).astype(np.float32)
    fe = MelFrontend("cpu", 22050, n_mels, n_fft, hop, int(22050 * 1.5))
    kern = TokenizerKernel(22050, n_mels, n_fft, hop, fe.frames_max, cents,
                           cuda_device, tier, vq_tier)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.5, 0.7, 1.2)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(cuda_device)
    before = TokenizerKernel.launches
    got = kern(x)
    assert TokenizerKernel.launches == before + 1
    coarse = "default" if "default" in (tier, vq_tier) else "bf16x3"
    ref = kern.plain(x)
    check_tier_ties(l2_normalize(kern.log_mel_plain(x)), kern.centroids,
                    got, ref, coarse)
    highest = TokenizerKernel(22050, n_mels, n_fft, hop, fe.frames_max, cents,
                              cuda_device)(x)
    check_follows_tier(got, ref, highest, coarse, min_rows=20, band=False)


@pytest.mark.cuda
@pytest.mark.parametrize("vq_tier", ["bf16x3", "default"])
@pytest.mark.parametrize("n_mels,k", [(128, 500), (130, 700)])
def test_cuda_tokenizer_vq_tier_takes_wide_mels(cuda_device, n_mels, k,
                                                vq_tier):
    """Past 64 mel bands the tiered argmin walks the features in slices
    (and past 128 the JAX megakernel still runs): the f32 front end with a
    bf16 vq_tier launches and holds to its plain tier version."""
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.tiers import check_tier_ties
    from audio_tokens_tpu_torch.ops.vq import l2_normalize

    rng = np.random.default_rng(k + n_mels)
    cents = rng.standard_normal((k, n_mels)).astype(np.float32)
    fe = MelFrontend("cpu", 22050, n_mels, 512, 128, int(22050 * 1.5))
    kern = TokenizerKernel(22050, n_mels, 512, 128, fe.frames_max, cents,
                           cuda_device, "highest", vq_tier)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.5, 0.7)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(cuda_device)
    before = TokenizerKernel.launches
    got = kern(x)
    assert TokenizerKernel.launches == before + 1
    check_tier_ties(l2_normalize(kern.log_mel_plain(x)), kern.centroids, got,
                    kern.plain(x), vq_tier)


# (n_fft, hop, n_mels): the shapes PR 16's mma.sync front end refused
# (C5): a hop off 16, a hop off 8 (its fragments gathered sample by
# sample), 256 mel bands (four 64-band slices, 64 frames a block)
C5_SHAPES = [(400, 200, 64), (400, 100, 64), (512, 128, 256),
             (400, 80, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("n_fft,hop,n_mels", C5_SHAPES)
def test_cuda_tokenizer_tier_takes_any_hop_and_wide_mels(cuda_device, n_fft,
                                                         hop, n_mels, tier):
    """B1 at (tier, tier) at the shapes the f32 front end and the JAX
    kernel take: one launch, held to its plain tier version."""
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.ops.mel import MelFrontend
    from audio_tokens_tpu_torch.ops.tiers import check_tier_ties
    from audio_tokens_tpu_torch.ops.vq import l2_normalize

    rng = np.random.default_rng(n_fft + hop + n_mels)
    cents = rng.standard_normal((500, n_mels)).astype(np.float32)
    fe = MelFrontend("cpu", 22050, n_mels, n_fft, hop, int(22050 * 1.5))
    kern = TokenizerKernel(22050, n_mels, n_fft, hop, fe.frames_max, cents,
                           cuda_device, tier, tier)
    clips = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.5, 0.7, 1.2)]
    x = torch.from_numpy(fe.prepare_batch(clips)[0]).to(cuda_device)
    before = TokenizerKernel.launches
    got = kern(x)
    assert TokenizerKernel.launches == before + 1
    check_tier_ties(l2_normalize(kern.log_mel_plain(x)), kern.centroids,
                    got, kern.plain(x), tier)


@pytest.mark.cuda
def test_cuda_tokenizer_tier_refuses_a_hop_off_16(cuda_device):
    """A hop that does not divide n_fft (hop 120 at n_fft 256, which the
    JAX kernel refuses too) raises at the bf16 tiers."""
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel

    kern = TokenizerKernel(22050, 32, 256, 120, 40, np.ones((5, 32),
                           np.float32), cuda_device, "bf16x3")
    with pytest.raises(ValueError, match="hop to divide n_fft"):
        kern(torch.zeros((1, 39 * 120 + 256), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("vq_tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_cuda_tokenizer_tier_plan_is_the_c_plan(cuda_device, tier, vq_tier):
    """The bf16 front end's launch plan in Python (``tier_plan``, which the
    wrapper refuses by) equals the C side's (``WgPlan``)."""
    import ctypes

    from audio_tokens_tpu_torch.ops import cuda_tokenizer as ct

    lib = ct._lib()
    for n_fft, hop, m in ([(512, h, 64) for h in (512, 128, 100, 8, 1)]
                          + [(400, h, 64) for h in (200, 100, 25)]
                          + [(512, 128, mm) for mm in (32, 130, 256, 512)]
                          + [(2048, 2048, 64)]):
        trows = -(-n_fft // ct.ROW_STAGE) * ct.ROW_STAGE
        out = (ctypes.c_long * 3)()
        lib.atk_tokenize_tier_plan(hop, trows, m, int(tier == "bf16x3"),
                                   ct.TIERS.index(vq_tier), out)
        assert tuple(out) == ct.tier_plan(hop, trows, m, tier, vq_tier), (
            n_fft, hop, m)


LSTM_SHAPES = [
    (24, 8, 128),   # 4 threads share each dot product
    (50, 1, 512),   # the single-clip request's batch
    (20, 256, 64),  # 1024 (b, u) pairs: one thread each
    (17, 6, 36),    # a ragged batch tile, H not a multiple of the tiles
    # B4's partition: batch rows not a multiple of a block's (two row
    # groups of 17), H not a multiple of its 8 or 16 units (masked edge)
    (9, 33, 64),
    (7, 5, 20),
    (6, 256, 512),  # B4's grid shrunk to stay resident: 128 rows a block
    (1, 8, 64),     # one step: no product
    (2, 33, 36),    # two steps: one product
    (5, 8, 1024),   # B3: h rows wider than one load round (H > 512)
    (3, 4, 600),    # the same, H/4 not a multiple of 32
]


def _lstm_inputs(device, t, b, h):
    gen = torch.Generator().manual_seed(0)
    xg = torch.randn((t, b, 4 * h), generator=gen).to(device)
    w = (torch.rand((h, 4 * h), generator=gen) * 0.2 - 0.1).to(device)
    lens = torch.randint(min(3, t), t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float().to(device)
    return gen, xg, mask, w


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", LSTM_SHAPES)
def test_cuda_lstm_kernel_matches_plain(cuda_device, reverse, t, b, h):
    """B3, with and without its residual stores."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_fwd,
                                                      lstm_sequence_fwd_plain)

    _, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    ref = lstm_sequence_fwd_plain(xg, mask, w, reverse)
    for residuals in (False, True):
        before = lstm_sequence_fwd.launches
        got = lstm_sequence_fwd(xg, mask, w, reverse, residuals)
        assert lstm_sequence_fwd.launches == before + 1
        for name, g, r in zip(("hs", "gates", "c", "h_last"), got, ref):
            if g is None:
                assert not residuals and name in ("gates", "c")
                continue
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", LSTM_SHAPES)
def test_cuda_lstm_backward_kernel_matches_plain(cuda_device, reverse, t, b,
                                                 h):
    """B4 on the plain forward's residuals: dxg within 1e-5, dw_hh within
    1e-5 of its largest entry (another summation order over T*B rows)."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_sequence_bwd, lstm_sequence_bwd_plain, lstm_sequence_fwd_plain)

    gen, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    hs, gates, c, _ = lstm_sequence_fwd_plain(xg, mask, w, reverse)
    dhs = torch.randn((t, b, h), generator=gen).to(cuda_device)
    dh_last = torch.randn((b, h), generator=gen).to(cuda_device)
    before = lstm_sequence_bwd.launches
    dxg, dw = lstm_sequence_bwd(dhs, dh_last, gates, c, hs, mask, w, reverse)
    assert lstm_sequence_bwd.launches == before + 1
    ref_dxg, ref_dw = lstm_sequence_bwd_plain(dhs, dh_last, gates, c, hs,
                                              mask, w, reverse)
    torch.testing.assert_close(dxg, ref_dxg, atol=1e-5, rtol=1e-5)
    assert float((dw - ref_dw).abs().max()) <= 1e-5 * float(
        ref_dw.abs().max())


@pytest.mark.cuda
def test_cuda_lstm_backward_is_bit_equal_between_launches(cuda_device):
    """A fixed partition and fixed-order sums: two launches of B4 on the
    same inputs give the same bits, and dw_hh equals its kernel run alone."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_dw_hh, lstm_sequence_bwd, lstm_sequence_fwd_plain)

    gen, xg, mask, w = _lstm_inputs(cuda_device, 12, 64, 512)
    dhs = torch.randn((12, 64, 512), generator=gen).to(cuda_device)
    dh_last = torch.randn((64, 512), generator=gen).to(cuda_device)
    for reverse in (False, True):
        hs, gates, c, _ = lstm_sequence_fwd_plain(xg, mask, w, reverse)
        args = (dhs, dh_last, gates, c, hs, mask, w, reverse)
        first, again = lstm_sequence_bwd(*args), lstm_sequence_bwd(*args)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                               again[1])
        assert torch.equal(lstm_dw_hh(hs, first[0], reverse), first[1])


# dw_hh's GEMM: B4's shapes (K = (T-1)*B = 0 at T 1; H 36 and 20 mask the
# 128-wide tiles), K not a multiple of a stage times the slices, and the
# training shape
DW_SHAPES = LSTM_SHAPES + [(13, 7, 64), (300, 37, 128), (1728, 64, 512)]


def _dw_inputs(device, t, b, h, reverse):
    gen = torch.Generator().manual_seed(t * 1000 + h + int(reverse))
    hs = torch.tanh(torch.randn((t, b, h), generator=gen)).to(device)
    dxg = (0.1 * torch.randn((t, b, 4 * h), generator=gen)).to(device)
    return hs, dxg


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", DW_SHAPES)
def test_cuda_lstm_dw_kernel_matches_plain(cuda_device, reverse, t, b, h):
    """B4's dw_hh GEMM alone within 1e-5 of the largest entry of its plain
    version (another summation order over (T-1)*B rows); all zeros at T 1."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_dw_hh,
                                                      lstm_dw_hh_plain)

    hs, dxg = _dw_inputs(cuda_device, t, b, h, reverse)
    before = lstm_dw_hh.launches
    got = lstm_dw_hh(hs, dxg, reverse)
    assert lstm_dw_hh.launches == before + 1
    ref = lstm_dw_hh_plain(hs, dxg, reverse)
    if t == 1:
        assert torch.equal(got, torch.zeros_like(got))
        return
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h", [(1728, 64, 512), (300, 37, 128)])
def test_cuda_lstm_dw_is_bit_equal_between_launches(cuda_device, t, b, h):
    """The split-K partials are summed in slice order, with no atomics: two
    launches give the same bits."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_dw_hh

    for reverse in (False, True):
        hs, dxg = _dw_inputs(cuda_device, t, b, h, reverse)
        assert torch.equal(lstm_dw_hh(hs, dxg, reverse),
                           lstm_dw_hh(hs, dxg, reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h", [(12, 64, 512), (9, 256, 512),
                                   (7, 33, 36)])
def test_cuda_lstm_forward_is_bit_equal_between_launches(cuda_device, t, b,
                                                         h):
    """A fixed partition and fixed-order sums: two launches of B3 give the
    same bits, with and without the residual stores, and the outputs they
    share agree bit for bit between the two."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import lstm_sequence_fwd

    _, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    for reverse in (False, True):
        plain = lstm_sequence_fwd(xg, mask, w, reverse)
        first = lstm_sequence_fwd(xg, mask, w, reverse, True)
        again = lstm_sequence_fwd(xg, mask, w, reverse, True)
        for a, b_ in zip(first, again):
            assert torch.equal(a, b_)
        assert torch.equal(plain[0], first[0])
        assert torch.equal(plain[3], first[3])


# chunked recurrences: chunks of 7 (T not a multiple), 16, and one of T
CARRY_CASES = [(100, 64, 512, 7), (100, 64, 512, 16), (37, 33, 36, 16),
               (20, 256, 512, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h,s", CARRY_CASES)
def test_cuda_lstm_chunks_from_carries_are_bit_equal(cuda_device, reverse, t,
                                                     b, h, s):
    """B3 launched once a time chunk, each from the last chunk's (h_last,
    c_last), gives the whole launch's hs, h_last and c_last bit for bit; the
    chunks' B4 (dc_last in, dh0 and dc0 out) gives its dxg bit for bit and
    its dw_hh within 1e-4 + 1e-3 relative (summed over chunks in another
    order).  The reverse direction walks the chunks from the end."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_carry,
                                                      lstm_sequence_fwd)

    gen, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    dhs = torch.randn((t, b, h), generator=gen).to(cuda_device)
    dh_last = torch.randn((b, h), generator=gen).to(cuda_device)
    x_full, w_full = xg.clone().requires_grad_(), w.clone().requires_grad_()
    hs, h_last, c_last = lstm_sequence_carry(x_full, mask, w_full, reverse)
    torch.autograd.backward((hs, h_last), (dhs, dh_last))
    x_ch, w_ch = xg.clone().requires_grad_(), w.clone().requires_grad_()
    starts = list(range(0, t, s))
    before = lstm_sequence_fwd.launches
    h = c = None
    outs = {}
    for t0 in (reversed(starts) if reverse else starts):
        outs[t0], h, c = lstm_sequence_carry(
            x_ch[t0:t0 + s], mask[t0:t0 + s], w_ch, reverse, h, c)
    assert lstm_sequence_fwd.launches == before + len(starts)
    hs_ch = torch.cat([outs[t0] for t0 in starts])
    assert torch.equal(hs_ch, hs)
    assert torch.equal(h, h_last) and torch.equal(c, c_last)
    torch.autograd.backward((hs_ch, h), (dhs, dh_last))
    assert torch.equal(x_ch.grad, x_full.grad)
    torch.testing.assert_close(w_ch.grad, w_full.grad, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", [(9, 64, 512), (1, 33, 36), (13, 7, 64)])
def test_cuda_lstm_carries_match_plain(cuda_device, reverse, t, b, h):
    """B3 from given carries and B4's carry outputs against the plain
    versions: hs, h_last, c_last within 1e-5, dxg, dh0, dc0 within 1e-5,
    dw_hh (with h0's term) within 1e-5 of its largest entry."""
    from audio_tokens_tpu_torch.ops.cuda_lstm import (
        lstm_dw_hh_plain, lstm_recurrence_bwd_plain, lstm_sequence_fwd_plain)

    gen, xg, mask, w = _lstm_inputs(cuda_device, t, b, h)
    h0, c0, dh_last, dc_last = (torch.randn((b, h), generator=gen).to(
        cuda_device) for _ in range(4))
    dhs = torch.randn((t, b, h), generator=gen).to(cuda_device)
    hs, h_last, gates, c, c_last = torch.ops.atk.lstm_fwd(
        xg, mask, w, reverse, True, h0, c0)
    ref = lstm_sequence_fwd_plain(xg, mask, w, reverse, h0, c0)
    for got, want in ((hs, ref[0]), (gates, ref[1]), (c, ref[2]),
                      (h_last, ref[3]), (c_last, ref[2][0 if reverse else -1])):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    dxg, dh0, dc0 = torch.ops.atk.lstm_bwd(dhs, dh_last, ref[1], ref[2], mask,
                                           w, reverse, dc_last, c0)
    want = lstm_recurrence_bwd_plain(dhs, dh_last, ref[1], ref[2], mask, w,
                                     reverse, dc_last, c0)
    for got, r in zip((dxg, dh0, dc0), want):
        torch.testing.assert_close(got, r, atol=1e-5, rtol=1e-5)
    dw = torch.ops.atk.lstm_dw(ref[0], want[0], reverse, h0)
    dw_ref = lstm_dw_hh_plain(ref[0], want[0], reverse, h0)
    assert float((dw - dw_ref).abs().max()) <= 1e-5 * float(
        dw_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 64])
def test_cuda_lstm_remat_matches_no_remat(cuda_device, chunk):
    """The classifier with ``lstm_remat_chunk`` on the card: logits within
    1e-5 and gradients within 1e-4 + 1e-3 relative of the run without remat
    (the chunks' input-gate products sum in another order), and B3 launched
    again for each chunk's recompute."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    gen = torch.Generator().manual_seed(4)
    t = 150
    toks = torch.randint(0, 50, (8, t), generator=gen).to(cuda_device)
    lens = torch.randint(5, t + 1, (8,), generator=gen).to(cuda_device)
    labels = (torch.rand((8, 7), generator=gen) < 0.3).float().to(cuda_device)
    row_w = torch.ones(8, device=cuda_device)
    out = {}
    for remat in (0, chunk):
        cfg = AudioTokensConfig(model_type="lstm", vocab_size=50,
                                num_classes=7, lstm_embed_dim=32,
                                lstm_hidden_dim=128, num_layers=2,
                                lstm_remat_chunk=remat)
        m = get_model(cfg, cuda_device, torch.Generator().manual_seed(0))
        fwd, bwd = lstm_sequence_fwd.launches, lstm_sequence_bwd.launches
        logits = m(toks, lens)
        weighted_bce(logits, labels, row_w).backward()
        n = 4 * (-(-t // remat)) if remat else 4
        assert lstm_sequence_fwd.launches - fwd == (2 * n if remat else n)
        assert lstm_sequence_bwd.launches - bwd == n
        out[remat] = (logits.detach(),
                      {k: p.grad for k, p in m.named_parameters()})
    torch.testing.assert_close(out[chunk][0], out[0][0], atol=1e-5, rtol=0)
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[chunk][1][k], g, atol=1e-4, rtol=1e-3,
                                   msg=k)


@pytest.mark.cuda
def test_cuda_device_epoch_reads_two_scalars_and_never_syncs(cuda_device):
    """A device-resident lstm epoch and its eval epoch on the card run under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in them reads the
    card or waits for it but the one read of two scalars an epoch
    (``read_scalars``, let through by the test), and B3 and B4 launch."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train import device_epoch
    from audio_tokens_tpu_torch.train.trainer import Trainer

    cfg = AudioTokensConfig(model_type="lstm", vocab_size=50, num_classes=7,
                            lstm_embed_dim=32, lstm_hidden_dim=128,
                            num_layers=1, max_seq_len=40, dropout=0.1,
                            training_batch_size=8, log_every_steps=0)
    trainer = Trainer(cfg, cuda_device)
    runner = device_epoch.DeviceEpochRunner(trainer)
    rng = np.random.default_rng(7)
    for split, n in (("train", 30), ("validation", 11)):
        n_pad = -(-n // 8) * 8
        toks = rng.integers(0, 50, (n_pad, 40)).astype(np.uint16)
        lens = rng.integers(1, 41, n_pad).astype(np.int32)
        labels = (rng.random((n_pad, 7)) < 0.3).astype(np.uint8)
        runner.set_corpus_arrays(split, toks, lens, labels, n, 8)
    read = device_epoch.read_scalars
    reads = []

    def let_through(*values):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(read(*values))
        finally:
            torch.cuda.set_sync_debug_mode("error")
        return reads[-1]

    device_epoch.read_scalars = let_through
    fwd, bwd = lstm_sequence_fwd.launches, lstm_sequence_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step, loss, m = runner.train_epoch(0, 0)
        val_loss, val_m = runner.eval_epoch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        device_epoch.read_scalars = read
    assert step == 4 and [len(r) for r in reads] == [2, 2]
    assert np.isfinite(loss) and np.isfinite(val_loss)
    assert 0.0 <= m["mAP"] <= 1.0 and 0.0 <= val_m["mAP"] <= 1.0
    assert lstm_sequence_fwd.launches - fwd == 2 * 4 + 2 * 2
    assert lstm_sequence_bwd.launches - bwd == 2 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("with_lengths", [False, True])
def test_cuda_classifier_backward_reaches_every_parameter(cuda_device,
                                                          with_lengths):
    """The fault this pins: the CUDA recurrence once returned tensors with
    no autograd history, so loss.backward() filled only the linear head.
    Now every parameter gets the CPU model's gradient (atol 1e-5)."""
    from audio_tokens_tpu_torch.models.lstm import SimpleLSTMTokenClassifier
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    def model(device):
        return SimpleLSTMTokenClassifier(
            50, 16, 64, 2, 7, device=device,
            generator=torch.Generator().manual_seed(0))

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 50, (6, 30), generator=gen)
    lens = torch.randint(5, 31, (6,), generator=gen)
    labels = (torch.rand((6, 7), generator=gen) < 0.3).float()
    row_w = torch.tensor([1.0, 1, 1, 1, 1, 0])
    grads = {}
    for device in ("cpu", cuda_device):
        m = model(device)
        fwd, bwd = lstm_sequence_fwd.launches, lstm_sequence_bwd.launches
        loss = weighted_bce(
            m(toks.to(device), lens.to(device) if with_lengths else None),
            labels.to(device), row_w.to(device))
        loss.backward()
        if device != "cpu":  # 2 layers x 2 directions, each way
            assert lstm_sequence_fwd.launches == fwd + 4
            assert lstm_sequence_bwd.launches == bwd + 4
        grads[str(device)] = {n: p.grad for n, p in m.named_parameters()}
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    assert sorted(card) == sorted(cpu)
    for name in cpu:
        assert card[name] is not None, f"{name} got no gradient on the card"
        torch.testing.assert_close(card[name].cpu(), cpu[name], atol=1e-5,
                                   rtol=1e-4, msg=name)


FLASH_SHAPES = [
    (2, 2, 100),   # one partial tile
    (1, 3, 257),   # T one past a tile multiple
    (3, 1, 64),    # exactly one tile
]
# bf16: P and the output each rounded to 8 bits (2^-8 relative), the
# kernel rounding P against its running row max, the plain version against
# the final one; outputs of magnitude below 4
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _flash_inputs(device, b, nh, t, dtype):
    gen = torch.Generator().manual_seed(t)
    q, k, v, do = (torch.randn((b, nh, t, 64), generator=gen).to(device,
                                                                  dtype)
                   for _ in range(4))
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[-1] = 0  # a row with no valid key: every query in segment 1
    seg = (torch.arange(t)[None, :] >= lens[:, None]).to(torch.int32)
    return q, k, v, do, seg.to(device)


def _prefix_segments(lens, t):
    """(B, T) int32 ids: 0 below each row's length, 1 from there on."""
    return (torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]).to(
        torch.int32)


def _interleaved_segments(b, t):
    """Three segments, ids 2, 5 and 9, interleaved position by position (no
    tile is all of one segment) and, in the last row, in thirds (tiles of
    one segment, ids that are not 0/1)."""
    ids = torch.tensor([2, 5, 9], dtype=torch.int32)
    seg = ids[torch.arange(t) % 3].repeat(b, 1)
    seg[-1] = ids[(torch.arange(t) * 3) // t]
    return seg


# (b, nh, t, segment ids or None for _flash_inputs' random prefix lengths)
FLASH_BWD_CASES = {
    **{f"{b}x{nh}x{t}": (b, nh, t, None) for b, nh, t in FLASH_SHAPES},
    "the-serving-length": (1, 2, 1728, None),
    "two-tiles-ragged": (2, 2, 130, None),
    "four-tiles-ragged": (2, 1, 200, None),
    # lengths that leave whole 64-row tiles masked, each way round
    "whole-tiles-masked": (4, 2, 200, _prefix_segments([0, 64, 65, 200], 200)),
    "three-segments": (2, 2, 200, _interleaved_segments(2, 200)),
    "three-segments-long": (2, 1, 450, _interleaved_segments(2, 450)),
    # more than 32 tiles: the list of tiles to walk is built in two rounds
    "35-tiles-prefix": (2, 1, 2200, None),
    "35-tiles-thirds": (1, 1, 2200, _interleaved_segments(1, 2200)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_cuda_flash_forward_matches_plain(cuda_device, dtype, case):
    """B5 forward, with and without the logsumexp store, on every row:
    partial and ragged tiles, whole tiles of another segment (left out by
    the kernels), three interleaved segments, more than 32 tiles."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_fwd, flash_attention_plain)

    b, nh, t, seg = FLASH_BWD_CASES[case]
    q, k, v, _, prefix = _flash_inputs(cuda_device, b, nh, t, dtype)
    seg = prefix if seg is None else seg.to(cuda_device)
    ref_o, ref_lse = flash_attention_plain(q, k, v, seg, 0.125, True)
    for lse in (False, True):
        before = flash_attention_fwd.launches
        o, got_lse = flash_attention_fwd(q, k, v, seg, 0.125, lse)
        assert flash_attention_fwd.launches == before + 1
        torch.testing.assert_close(o.float(), ref_o.float(),
                                   **FLASH_TOL[dtype])
        if lse:
            torch.testing.assert_close(got_lse, ref_lse, atol=1e-5,
                                       rtol=1e-5)
        else:
            assert got_lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["whole-tiles-masked", "three-segments-long",
                                  "35-tiles-prefix"])
@pytest.mark.parametrize("rows", [(0, 64), (70, 131), (1, 2)])
def test_cuda_flash_forward_query_block_matches_plain(cuda_device, dtype,
                                                      case, rows):
    """B5 on a query block (a sequence rank's rows against every key,
    ``kv_segment_ids``; ragged blocks, one row): the forward against its
    plain version and the full window's output rows; the dk/dv and dq
    kernels (dk, dv of every key, dq of the block's rows) against the
    plain backward; autograd through ``flash_attention`` launching each
    once, against the plain backward too."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_plain, flash_attention_dq_plain,
        flash_attention_fwd, flash_attention_plain)

    b, nh, t, seg = FLASH_BWD_CASES[case]
    q, k, v, do, prefix = _flash_inputs(cuda_device, b, nh, t, dtype)
    seg = prefix if seg is None else seg.to(cuda_device)
    lo, hi = rows
    qb, seg_q = q[:, :, lo:hi].contiguous(), seg[:, lo:hi].contiguous()
    do = do[:, :, lo:hi].contiguous()
    ref_o, ref_lse = flash_attention_plain(qb, k, v, seg_q, 0.125, True,
                                           kv_segment_ids=seg)
    o, lse = flash_attention_fwd(qb, k, v, seg_q, 0.125, True,
                                 kv_segment_ids=seg)
    torch.testing.assert_close(o.float(), ref_o.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    full = flash_attention_fwd(q, k, v, seg, 0.125)[0][:, :, lo:hi]
    assert torch.equal(o, full)
    di = (ref_o.float() * do.float()).sum(-1)
    args = (qb, k, v, seg_q, ref_lse, do, di, 0.125, seg)
    got = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
    want = (*flash_attention_dkv_plain(*args),
            flash_attention_dq_plain(*args))
    for name, g, r in zip(("dk", "dv", "dq"), got, want):
        assert g.shape == r.shape and g.dtype == dtype, name
        torch.testing.assert_close(g.float(), r.float(), **FLASH_TOL[dtype],
                                   msg=name)
    leaves = [a.clone().requires_grad_() for a in (qb, k, v)]
    launches = (flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches)
    grads = torch.autograd.grad(flash_attention(
        *leaves, seg_q, 0.125, kv_segment_ids=seg), leaves, do)
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), grads,
                          (want[2], want[0], want[1])):
        torch.testing.assert_close(g.float(), r.float(), **FLASH_TOL[dtype],
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_forward_is_bit_equal_between_launches(cuda_device,
                                                          dtype):
    """A fixed walk and no atomics: two launches of the forward on the same
    inputs give the same output and logsumexp bits."""
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd

    q, k, v, _, _ = _flash_inputs(cuda_device, 3, 2, 450, dtype)
    seg = _interleaved_segments(3, 450).to(cuda_device)
    first = flash_attention_fwd(q, k, v, seg, 0.125, True)
    again = flash_attention_fwd(q, k, v, seg, 0.125, True)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_cuda_flash_forward_refuses_misaligned_bf16(cuda_device):
    """The bf16 forward copies 16 bytes at a time too: a head that starts 2
    bytes off a 16-byte boundary is refused by the launch, not read."""
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd

    q, k, v, _, seg = _flash_inputs(cuda_device, 1, 1, 64, torch.bfloat16)
    off = torch.empty(k.numel() + 1, dtype=k.dtype, device=k.device)[1:]
    k = off.view(q.shape).copy_(k)
    assert k.is_contiguous() and k.data_ptr() % 16 == 2
    with pytest.raises(RuntimeError, match="misaligned"):
        flash_attention_fwd(q, k, v, seg, 0.125)


@pytest.mark.cuda
def test_cuda_flash_f32_forward_beats_one_tf32_pass(cuda_device):
    """The f32 forward is 3xTF32, not one TF32 pass: on randn inputs at the
    serving length, the largest error of o and of the logsumexp against the
    plain version is at most 1/20 of the plain version's own error with
    TF32 matmuls (one pass)."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_fwd, flash_attention_plain)

    b, nh, t, _ = FLASH_BWD_CASES["the-serving-length"]
    q, k, v, _, seg = _flash_inputs(cuda_device, b, nh, t, torch.float32)
    got = flash_attention_fwd(q, k, v, seg, 0.125, True)
    ref = flash_attention_plain(q, k, v, seg, 0.125, True)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = flash_attention_plain(q, k, v, seg, 0.125, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for name, g, r, x in zip(("o", "lse"), got, ref, one_pass):
        err = float((g - r).abs().max())
        tf32_err = float((x - r).abs().max())
        assert tf32_err > 0, name  # TF32 did round the plain version
        assert err <= tf32_err / 20, (name, err, tf32_err)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])  # q, k, v
def test_cuda_flash_f32_forward_refuses_misaligned(cuda_device, which):
    """The 3xTF32 forward copies 16 bytes at a time: an f32 head that starts
    one float off a 16-byte boundary is refused by the launch, not read,
    and the launch counter does not move."""
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd

    args = list(_flash_inputs(cuda_device, 1, 1, 64, torch.float32))
    x = args[which]
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    args[which] = off.view(x.shape).copy_(x)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16 == 4
    q, k, v, _, seg = args
    before = flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        flash_attention_fwd(q, k, v, seg, 0.125)
    assert flash_attention_fwd.launches == before


def _flash_backward_args(device, dtype, b, nh, t, seg):
    """The backward kernels' arguments on the plain forward's logsumexp."""
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_plain

    q, k, v, do, prefix = _flash_inputs(device, b, nh, t, dtype)
    seg = prefix if seg is None else seg.to(device)
    o, lse = flash_attention_plain(q, k, v, seg, 0.125, True)
    di = (o.float() * do.float()).sum(-1)
    return q, k, v, seg, lse, do, di, 0.125


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_cuda_flash_backward_matches_plain(cuda_device, dtype, case):
    """The dk/dv and dq kernels on the plain forward's logsumexp: each
    gradient within 1e-5 (f32) or 2e-2 (bf16: P, dS and the outputs each
    rounded to 8 bits) of its largest entry."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_plain, flash_attention_dq_plain)

    args = _flash_backward_args(cuda_device, dtype, *FLASH_BWD_CASES[case])
    launches = (flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches)
    got = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    ref = (*flash_attention_dkv_plain(*args), flash_attention_dq_plain(*args))
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for name, g, r in zip(("dk", "dv", "dq"), got, ref):
        assert g.dtype == dtype
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - r.float()).abs().max())
        assert err <= rel * float(r.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_is_bit_equal_between_launches(cuda_device,
                                                           dtype):
    """No atomics and a fixed walk: two launches of each backward kernel on
    the same inputs give the same bits."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    args = _flash_backward_args(cuda_device, dtype, 3, 2, 450,
                                _interleaved_segments(3, 450))
    first = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
    again = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
    for name, a, b in zip(("dk", "dv", "dq"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_flash_backward_refuses_misaligned_bf16(cuda_device):
    """The bf16 backward copies 16 bytes at a time: heads that start 2 bytes
    off a 16-byte boundary are refused by the launch, not read."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    args = list(_flash_backward_args(cuda_device, torch.bfloat16, 1, 1, 64,
                                     None))
    q = args[0]
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:]
    args[0] = off.view(q.shape).copy_(q)
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 == 2
    for kernel in (flash_attention_bwd_dkv, flash_attention_bwd_dq):
        with pytest.raises(RuntimeError, match="misaligned"):
            kernel(*args)


@pytest.mark.cuda
def test_cuda_flash_f32_backward_beats_one_tf32_pass(cuda_device):
    """The f32 pair is 3xTF32, not one TF32 pass: on randn inputs (mantissa
    bits below TF32's 10) at the serving length, each gradient's largest
    error against the plain version is at most 1/20 of the plain version's
    own error with TF32 matmuls (one pass)."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_plain, flash_attention_dq_plain)

    args = _flash_backward_args(cuda_device, torch.float32,
                                *FLASH_BWD_CASES["the-serving-length"])
    got = (*flash_attention_bwd_dkv(*args), flash_attention_bwd_dq(*args))
    ref = (*flash_attention_dkv_plain(*args), flash_attention_dq_plain(*args))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = (*flash_attention_dkv_plain(*args),
                    flash_attention_dq_plain(*args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for name, g, r, x in zip(("dk", "dv", "dq"), got, ref, one_pass):
        err = float((g - r).abs().max())
        tf32_err = float((x - r).abs().max())
        assert tf32_err > 0, name  # TF32 did round the plain version
        assert err <= tf32_err / 20, (name, err, tf32_err)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2, 5])  # q, k, v, do
def test_cuda_flash_f32_backward_refuses_misaligned(cuda_device, which):
    """The 3xTF32 pair copies 16 bytes at a time: an f32 head that starts
    one float off a 16-byte boundary is refused by both launches, not
    read."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    args = list(_flash_backward_args(cuda_device, torch.float32, 1, 1, 64,
                                     None))
    x = args[which]
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    args[which] = off.view(x.shape).copy_(x)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16 == 4
    for kernel in (flash_attention_bwd_dkv, flash_attention_bwd_dq):
        before = kernel.launches
        with pytest.raises(RuntimeError, match="misaligned"):
            kernel(*args)
        assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_autograd_runs_the_three_kernels(cuda_device, dtype):
    """``flash_attention``'s autograd on the card: one forward, one dk/dv
    and one dq launch, gradients equal to autograd through the plain forward (f32
    within 1e-4; bf16, where the kernels round P and dS and autograd does
    not, within 2e-2 of the largest entry)."""
    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd, flash_attention_plain)

    q, k, v, do, seg = _flash_inputs(cuda_device, 2, 2, 130, dtype)
    counters = (flash_attention_fwd, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, seg, 0.125)
    got = torch.autograd.grad(o, leaves, do)
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        flash_attention_plain(*ref_leaves, seg, 0.125), ref_leaves, do)
    for g, r in zip(got, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
        else:
            err = float((g.float() - r.float()).abs().max())
            assert err <= 2e-2 * float(r.float().abs().max())


@pytest.mark.cuda
def test_cuda_bert_eval_matches_cpu(cuda_device):
    """The bert classifier in eval mode (the B5 route) on the card vs the
    CPU (plain attention version), f32, lengths with a 0 (atol 1e-4)."""
    from audio_tokens_tpu_torch.models.transformer import (
        TransformerClassifier)
    from audio_tokens_tpu_torch.ops.cuda_attention import flash_attention_fwd

    def model(device):
        m = TransformerClassifier(50, 2, 7, 128, 200, 0.0, torch.float32,
                                  "flash", device=device,
                                  generator=torch.Generator().manual_seed(0))
        return m.eval()

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 50, (4, 150), generator=gen)
    lens = torch.tensor([150, 77, 1, 0])
    out = {}
    for device in ("cpu", cuda_device):
        before = flash_attention_fwd.launches
        with torch.inference_mode():
            out[str(device)] = model(device)(toks.to(device),
                                             lens.to(device)).cpu()
        if device != "cpu":
            assert flash_attention_fwd.launches == before + 2  # 2 layers
    torch.testing.assert_close(out[str(cuda_device)], out["cpu"], atol=1e-4,
                               rtol=1e-4)


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.mark.cuda
def test_cuda_kmeans_step_matches_the_plain_assignment(cuda_device,
                                                       monkeypatch):
    """One Lloyd step on the card through B2 against the same step through
    B2's plain version on the card: assignments under the near-tie rule,
    centroids within 1e-5 where the two assignments agree."""
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin_plain
    from audio_tokens_tpu_torch.ops.vq import check_near_ties

    x = _unit_rows(200_000, 64, 0).to(cuda_device)
    init = x[:500].clone()
    got, _ = km.kmeans_fit(x, 500, 1, init_centroids=init)
    ids = km.assign(x, init)
    monkeypatch.setattr(km, "vq_argmin", vq_argmin_plain)
    ref, _ = km.kmeans_fit(x, 500, 1, init_centroids=init)
    ids_ref = km.assign(x, init)
    check_near_ties(x, init, ids, ids_ref)
    moved = torch.cat([ids[ids != ids_ref], ids_ref[ids != ids_ref]])
    same = torch.ones(500, dtype=torch.bool, device=cuda_device)
    same[moved.long()] = False
    torch.testing.assert_close(got[same], ref[same], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_kmeans_fits_are_bit_equal_and_launch_b2_each_iteration(
        cuda_device):
    """Two fits of the same points on the card give the same bits (the sums
    are one-hot GEMMs added in order, no atomics), and each fit launches B2
    once an iteration."""
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin

    x = _unit_rows(150_001, 64, 1).to(cuda_device)
    fits = []
    for _ in range(2):
        before = vq_argmin.launches
        fits.append(km.kmeans_fit(x, 500, 6, seed=3))
        assert vq_argmin.launches == before + 6
    assert fits[0][0].device == x.device
    assert torch.equal(fits[0][0], fits[1][0]) and fits[0][1] == fits[1][1]


@pytest.mark.cuda
def test_cuda_kmeans_warm_start_and_split_on_the_card(cuda_device):
    """The warm-start class on the card against the same schedule on the
    CPU (well-separated blobs, 1e-5), and ``split_largest`` repairs an
    empty cluster there as on the CPU."""
    from audio_tokens_tpu_torch.ops import kmeans as km

    rng = np.random.default_rng(2)
    centers = rng.standard_normal((8, 16)) * 2.0
    x = (centers[rng.integers(0, 8, 8000)]
         + rng.standard_normal((8000, 16))).astype(np.float32)
    out = {}
    for device in ("cpu", cuda_device):
        k = km.KMeans(16, 8, niter=5, seed=4, device=device)
        k.train(x[:4000])
        k.train(x[4000:], init_centroids=k.centroids)
        init = torch.from_numpy(x[:5].copy())
        init[2] = 1e3
        split, _ = km.kmeans_fit(x, 5, 3, init_centroids=init,
                                 empty_policy="split_largest", device=device)
        out[str(device)] = (k.centroids.cpu(), k.obj, split.cpu())
    cpu, card = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(card[0], cpu[0], atol=1e-5, rtol=0)
    assert abs(card[1] - cpu[1]) <= 1e-5 * abs(cpu[1])
    torch.testing.assert_close(card[2], cpu[2], atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_cuda_kmeans_stream_replays_are_bit_equal(cuda_device, tmp_path,
                                                  wire):
    """The streaming fit on the card from host pieces through the pinned
    ring: re-streamed, host-cached, device-cached and spilled fits give the
    same bits, each launches B2 once a super-batch an iteration, and they
    agree within 1e-5 with the in-memory fit of the same (wire-rounded)
    rows on the card."""
    from audio_tokens_tpu_torch.ops import kmeans as km
    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin

    x = _unit_rows(70_000, 64, 5).numpy()
    init = x[np.random.default_rng(5).choice(len(x), 100, replace=False)]

    def stream():
        return (x[i : i + 9000] for i in range(0, len(x), 9000))

    fits = []
    for caches in ({}, {"cache_mb": 64}, {"hbm_cache_mb": 64},
                   {"cache_spill_path": tmp_path / "s.bin",
                    "cache_spill_mb": 64}):
        before = vq_argmin.launches
        fits.append(km.kmeans_fit_streaming(
            stream, 100, 3, d=64, init_centroids=init, superbatch_rows=16384,
            wire_dtype=km.WIRES[wire], device=cuda_device, **caches))
        assert vq_argmin.launches - before == 5 * 3
    for c, obj, n in fits[1:]:
        assert torch.equal(c, fits[0][0]) and obj == fits[0][1] and n == len(x)
    rows = torch.from_numpy(x).to(cuda_device)
    if wire == "bf16":
        rows = rows.bfloat16().float()
    ref, ref_obj = km.kmeans_fit(rows, 100, 3, init_centroids=init)
    torch.testing.assert_close(fits[0][0], ref, atol=1e-5, rtol=0)
    assert abs(fits[0][1] - ref_obj) <= 1e-5 * abs(ref_obj)


@pytest.mark.cuda
def test_cuda_kmeans_stream_takes_device_feeds_untouched(cuda_device):
    """CUDA tensors of one super-batch pass the feeder untouched, and the
    fit equals the fit of the same rows streamed from the host."""
    from audio_tokens_tpu_torch.ops import kmeans as km

    x = _unit_rows(3 * 16384, 32, 6).to(cuda_device)
    host = x.cpu().numpy()
    kw = dict(d=32, init_centroids=host[:50], superbatch_rows=16384,
              hbm_cache_mb=64, cache_mb=64, device=cuda_device)
    feeds = [x[i : i + 16384] for i in range(0, len(x), 16384)]
    packed = list(km._SuperbatchFeeder(16384, 32).feeds(iter(feeds)))
    assert all(buf is feed for (buf, _), feed in zip(packed, feeds))
    on_card = km.kmeans_fit_streaming(lambda: iter(feeds), 50, 3, **kw)
    from_host = km.kmeans_fit_streaming(
        lambda: iter([host[i : i + 5000] for i in range(0, len(host), 5000)]),
        50, 3, **kw)
    assert torch.equal(on_card[0], from_host[0])
    assert on_card[1:] == from_host[1:]


def _wav_workspace(base, n_train: int = 10, n_val: int = 2):
    """A split file and short 16-bit wavs of varied lengths (the fused
    mode's inputs), written with the port's own wav writer."""
    import json

    from audio_tokens_tpu_torch.data.audio_io import write_pcm_wav

    rng = np.random.default_rng(4)
    ytids = [f"yt{i:04d}" for i in range(n_train + n_val)]
    for i, y in enumerate(ytids):
        t = np.arange(int(22050 * (2.0 + 0.3 * (i % 4)))) / 22050
        x = np.sin(2 * np.pi * 110.0 * (1 + i % 5) * t) \
            + 0.1 * rng.standard_normal(len(t))
        write_pcm_wav(base / "audioset" / "bal_train" / y[:2] / f"{y}.wav",
                      (0.5 * x / np.abs(x).max()).astype(np.float32), 22050)
    (base / "output").mkdir(parents=True)
    (base / "output" / "bal_train_data_split.json").write_text(json.dumps(
        {"train": ytids[:n_train], "validation": ytids[n_train:]}))


def _fused_config(base, **over):
    from audio_tokens_tpu_torch.config import AudioTokensConfig

    return AudioTokensConfig(
        base_dir=str(base), fused_pipeline=True, kmeans_mode="full",
        clip_seconds=3.0, n_mels=32, n_fft=256, hop_length=128,
        device_batch_size=4, vocab_size=16, niter=4, **over)


@pytest.mark.cuda
def test_cuda_fused_device_feed_rows_equal_host_route(cuda_device, tmp_path):
    """The device feed's rows on the card equal the host-mediated route's
    (spectrograms to the host, frames back, L2 on the card) bit for bit."""
    from audio_tokens_tpu_torch.processors import ClusterCreator

    _wav_workspace(tmp_path)
    cc = ClusterCreator(_fused_config(tmp_path), cuda_device)
    buffer, n = cc._fused_frames_device()
    host = torch.cat(list(cc._batch_generator(10)))
    assert buffer.is_cuda and host.is_cuda
    assert torch.equal(buffer[:n], host)
    frames, manifest = cc.take_resident_frames()
    assert frames.data_ptr() == buffer.data_ptr() and len(manifest) == 10


@pytest.mark.cuda
def test_cuda_assign_resident_reads_a_view(cuda_device):
    """The resident assignment (B2, ``normalize=False``) over a view of a
    capacity buffer, dense and sparse, against the plain version."""
    from types import SimpleNamespace

    from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain
    from audio_tokens_tpu_torch.ops.vq import check_near_ties
    from audio_tokens_tpu_torch.processors import SpecTokenizer

    rows = _unit_rows(6000, 64, 8)
    buffer = torch.full((8192, 64), float("nan"), device=cuda_device)
    buffer[:6000] = rows.to(cuda_device)
    view = buffer[:6000]
    cents = _unit_rows(500, 64, 9).to(cuda_device)
    manifest = {f"y{i}": (i * 600, 600) for i in range(10)}
    stub = SimpleNamespace(centroids=cents)
    before = vq_argmin.launches
    dense = SpecTokenizer._assign_resident(stub, view, manifest,
                                           list(manifest))
    sparse = SpecTokenizer._assign_resident(stub, view, manifest, ["y4"])
    assert vq_argmin.launches == before + 2
    np.testing.assert_array_equal(sparse["y4"], dense["y4"])
    ref = vq_argmin_plain(view, cents, False).cpu()
    got = torch.from_numpy(np.concatenate([dense[y] for y in manifest]))
    check_near_ties(view, cents, got, ref)


@pytest.mark.cuda
def test_cuda_streaming_conv_rows_come_from_the_card(cuda_device, tmp_path,
                                                     monkeypatch):
    """Under ``use_convolution`` the streaming fit's host rows are widened
    and normalized on the stage's device (cuDNN, TF32 off) and brought
    back: the CPU stage's rows within 1e-6."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.conv_features import ConvFeatures
    from audio_tokens_tpu_torch.processors.cluster_creator import (
        ClusterCreator,
    )

    cfg = AudioTokensConfig(base_dir=str(tmp_path), use_convolution=True)
    card, host = ClusterCreator(cfg, cuda_device), ClusterCreator(cfg, "cpu")
    host.conv.load_state_dict(card.conv.state_dict())
    devices = []
    forward = ConvFeatures.forward

    def spy(self, frames):
        devices.append(frames.device.type)
        return forward(self, frames)

    monkeypatch.setattr(ConvFeatures, "forward", spy)
    frames = np.random.default_rng(4).standard_normal(
        (5000, cfg.n_mels)).astype(np.float32)
    got = card._host_frames(frames)
    want = host._host_frames(frames)
    assert devices == ["cuda", "cpu"]
    assert isinstance(got, np.ndarray)
    assert got.shape == (5000, cfg.n_mels * cfg.num_kernels)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# the simple, cnn and baseline families: no kernel of their own; cuDNN
# convolutions and cuBLAS products on the card (TF32 off) vs the CPU
FAMILY_CFG = dict(num_classes=7, vocab_size=48, hidden_size=32, n_mels=32,
                  max_seq_len=67, n_fft=256, hop_length=128,
                  clip_seconds=1.5)


def _family_inputs(model_type, cfg, gen):
    if model_type == "simple":
        return torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len),
                             generator=gen)
    x = 20.0 * torch.randn((4, cfg.max_seq_len, cfg.n_mels), generator=gen)
    return x.reshape(4, -1) if model_type == "baseline" else x


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,dtype", [
    ("simple", "float32"), ("cnn", "float32"), ("cnn", "bfloat16"),
    ("baseline", "float32"), ("baseline", "bfloat16")])
def test_cuda_family_forward_backward_matches_cpu(cuda_device, model_type,
                                                  dtype):
    """Logits, loss and every gradient of one weighted-BCE step on the card
    vs the CPU, the same weights (odd max_seq_len 67: pooling floors).
    f32: atol 1e-4 + rtol 1e-3; bf16: within 2e-2 of each tensor's largest
    entry (one bf16 rounding apart, 2**-8, carried through the layers)."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.train.objective import weighted_bce

    cfg = AudioTokensConfig(model_type=model_type, compute_dtype=dtype,
                            **FAMILY_CFG)
    gen = torch.Generator().manual_seed(3)
    x = _family_inputs(model_type, cfg, gen)
    lens = torch.tensor([67, 30, 1, 0])
    labels = (torch.rand((4, 7), generator=gen) < 0.3).float()
    row_w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    out = {}
    for device in ("cpu", cuda_device):
        model = get_model(cfg, device, torch.Generator().manual_seed(0))
        logits = model(x.to(device), lens.to(device)
                       if model_type == "simple" else None)
        loss = weighted_bce(logits, labels.to(device), row_w.to(device))
        loss.backward()
        out[str(device)] = (logits.detach().cpu(), loss.detach().cpu(),
                            {n: p.grad.cpu()
                             for n, p in model.named_parameters()})
    card, cpu = out[str(cuda_device)], out["cpu"]
    assert card[0].dtype == torch.float32
    for name, got, ref in [("logits", card[0], cpu[0]),
                           ("loss", card[1], cpu[1]),
                           *[(n, card[2][n], cpu[2][n]) for n in cpu[2]]]:
        if dtype == "float32":
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-3,
                                       msg=name)
        else:
            err = float((got - ref).abs().max())
            assert err <= 2e-2 * float(ref.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["cnn", "baseline"])
def test_cuda_serving_program_from_checkpoint_spec_and_flat(
        cuda_device, tmp_path, model_type):
    """``ServingProgram(config)`` on the card for a spec and a flat family:
    centroids and a checkpoint on disk, B1's tokens equal to
    ``FusedTokenizer``'s, probabilities within 1e-4 of the CPU program's
    (f32: the card's mel frontend sums the DFT in another order)."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer
    from audio_tokens_tpu_torch.train.checkpoint import save_checkpoint

    cfg = AudioTokensConfig(base_dir=str(tmp_path), model_type=model_type,
                            compute_dtype="float32", **FAMILY_CFG)
    (tmp_path / "output").mkdir()
    np.save(cfg.centroids_path, _unit_rows(48, 32, 4).numpy())
    save_checkpoint(cfg.checkpoint_dir, "no-wandb-best",
                    get_model(cfg, "cpu", torch.Generator().manual_seed(2)))
    rng = np.random.default_rng(6)
    waves = [rng.standard_normal(int(22050 * s)).astype(np.float32)
             for s in (1.5, 0.8, 1.2)]
    progs = {d: ServingProgram(cfg, device=d) for d in ("cpu", cuda_device)}
    batch, lengths = progs["cpu"].tokenizer.frontend.prepare_batch(waves)
    x, ln = torch.from_numpy(batch), torch.from_numpy(lengths)
    before = TokenizerKernel.launches
    tokens, n_valid, probs = progs[cuda_device](x, ln)
    assert TokenizerKernel.launches == before + 1
    ref = FusedTokenizer.from_artifacts(cfg, cuda_device).tokens_from_padded(
        x.to(cuda_device))
    torch.testing.assert_close(tokens, ref, atol=0, rtol=0)
    _, n_cpu, probs_cpu = progs["cpu"](x, ln)
    torch.testing.assert_close(n_valid.cpu(), n_cpu, atol=0, rtol=0)
    torch.testing.assert_close(probs.cpu(), probs_cpu, atol=1e-4, rtol=0)


# -- the member axis (train/ensemble.py): the kernels' vmap rules -------------
def _count_plain(monkeypatch):
    """Count calls of the plain versions behind the ops' CPU
    registrations: on CUDA tensors a rule must never reach them."""
    from audio_tokens_tpu_torch.ops import cuda_attention, cuda_lstm

    calls = []
    for mod, name in ((cuda_lstm, "lstm_sequence_fwd_plain"),
                      (cuda_lstm, "lstm_recurrence_bwd_plain"),
                      (cuda_lstm, "lstm_dw_hh_plain"),
                      (cuda_attention, "flash_attention_plain"),
                      (cuda_attention, "flash_attention_dkv_plain"),
                      (cuda_attention, "flash_attention_dq_plain")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("carries", [False, True])
def test_cuda_lstm_rules_launch_a_member_and_equal_member_calls(
        cuda_device, monkeypatch, carries):
    """B3, B4's recurrence and ``dw_hh`` under ``torch.func.vmap``: one
    launch a member, outputs bit-equal to the per-member kernel calls, no
    plain version."""
    from torch.func import vmap

    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_dw_hh,
                                                      lstm_sequence_bwd,
                                                      lstm_sequence_fwd)

    calls = _count_plain(monkeypatch)
    k, t, b, h = 3, 50, 16, 128
    g = torch.Generator().manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(cuda_device)

    xg, w_hh = rnd(k, t, b, 4 * h), rnd(k, h, 4 * h, scale=0.1)
    lens = torch.randint(1, t + 1, (b,), generator=g)
    mask = (torch.arange(t)[:, None] < lens[None, :]).float().to(cuda_device)
    h0 = rnd(k, b, h) if carries else None
    c0 = rnd(k, b, h) if carries else None
    cd = 0 if carries else None
    fwd = (lstm_sequence_fwd.launches, lstm_sequence_bwd.launches,
           lstm_dw_hh.launches)

    def f(x, w, h_, c_):
        return torch.ops.atk.lstm_fwd(x, mask, w, True, True, h_, c_)

    got = vmap(f, in_dims=(0, 0, cd, cd))(xg, w_hh, h0, c0)
    assert lstm_sequence_fwd.launches - fwd[0] == k
    for i in range(k):
        want = torch.ops.atk.lstm_fwd(xg[i], mask, w_hh[i], True, True,
                                      None if h0 is None else h0[i],
                                      None if c0 is None else c0[i])
        for a, w in zip(got, want):
            assert torch.equal(a[i], w)
    hs, _, gates, c, _ = got
    dhs, dh_last = rnd(k, t, b, h), rnd(k, b, h)
    dc_last = rnd(k, b, h) if carries else None
    base = lstm_sequence_bwd.launches

    def bwd(a, b_, gg, cc, w, dcl, c0_):
        return torch.ops.atk.lstm_bwd(a, b_, gg, cc, mask, w, True, dcl, c0_)

    gb = vmap(bwd, in_dims=(0, 0, 0, 0, 0, cd, cd))(
        dhs, dh_last, gates, c, w_hh, dc_last, c0)
    assert lstm_sequence_bwd.launches - base == k
    base = lstm_dw_hh.launches
    dw = vmap(lambda hh, d, h_: torch.ops.atk.lstm_dw(hh, d, True, h_),
              in_dims=(0, 0, cd))(hs, gb[0], h0)
    assert lstm_dw_hh.launches - base == k
    for i in range(k):
        want = torch.ops.atk.lstm_bwd(
            dhs[i], dh_last[i], gates[i], c[i], mask, w_hh[i], True,
            None if dc_last is None else dc_last[i],
            None if c0 is None else c0[i])
        for a, w in zip(gb, want):
            assert torch.equal(a[i], w)
        assert torch.equal(dw[i], torch.ops.atk.lstm_dw(
            hs[i], gb[0][i], True, None if h0 is None else h0[i]))
    assert calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_rules_fold_the_members_into_one_launch(
        cuda_device, monkeypatch, dtype):
    """B5's forward, dk/dv and dq under ``torch.func.vmap``: one launch
    for all members, bit-equal to the kernel on the members stacked into
    the batch, no plain version."""
    from torch.func import vmap

    from audio_tokens_tpu_torch.ops.cuda_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)

    calls = _count_plain(monkeypatch)
    k, b, nh, t = 3, 2, 4, 200
    g = torch.Generator().manual_seed(12)
    q, kk, v, do = ((torch.randn((k, b, nh, t, 64), generator=g) * 0.5)
                    .to(dtype).to(cuda_device) for _ in range(4))
    lens = torch.tensor([0, 130])
    seg = (torch.arange(t)[None, :] >= lens[:, None]).int().to(cuda_device)
    before = flash_attention_fwd.launches
    o, lse = vmap(lambda *a: torch.ops.atk.flash_fwd(*a, seg, 0.125, True))(
        q, kk, v)
    assert flash_attention_fwd.launches - before == 1
    flat = [x.reshape(k * b, nh, t, 64) for x in (q, kk, v)]
    want_o, want_lse = torch.ops.atk.flash_fwd(*flat, seg.repeat(k, 1),
                                               0.125, True)
    assert torch.equal(o.reshape(want_o.shape), want_o)
    assert torch.equal(lse.reshape(want_lse.shape), want_lse)
    di = (o.float() * do.float()).sum(-1)
    before = (flash_attention_bwd_dkv.launches,
              flash_attention_bwd_dq.launches)
    dkv = vmap(lambda *a: torch.ops.atk.flash_bwd_dkv(
        a[0], a[1], a[2], seg, *a[3:], 0.125))(q, kk, v, lse, do, di)
    dq = vmap(lambda *a: torch.ops.atk.flash_bwd_dq(
        a[0], a[1], a[2], seg, *a[3:], 0.125))(q, kk, v, lse, do, di)
    assert (flash_attention_bwd_dkv.launches - before[0],
            flash_attention_bwd_dq.launches - before[1]) == (1, 1)
    rest = [x.reshape(k * b, *x.shape[2:]) for x in (lse, do, di)]
    want_dk, want_dv = torch.ops.atk.flash_bwd_dkv(
        *flat, seg.repeat(k, 1), *rest, 0.125)
    assert torch.equal(dkv[0].reshape(want_dk.shape), want_dk)
    assert torch.equal(dkv[1].reshape(want_dv.shape), want_dv)
    assert torch.equal(dq.reshape(want_dk.shape), torch.ops.atk.flash_bwd_dq(
        *flat, seg.repeat(k, 1), *rest, 0.125))
    assert calls == []


@pytest.mark.cuda
def test_cuda_ensemble_epoch_runs_the_kernels_without_sync(cuda_device,
                                                           monkeypatch):
    """An lstm ensemble of K members with dropout on the card: its
    training and eval epochs under ``torch.cuda.set_sync_debug_mode(
    "error")`` but the one read of 2K + 1 scalars an epoch, B3 launched K
    times a direction and step (and B4 in training) through the rule, no
    plain version; member 0 within 1e-4 of the single device epoch."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.cuda_lstm import (lstm_sequence_bwd,
                                                      lstm_sequence_fwd)
    from audio_tokens_tpu_torch.train import device_epoch
    from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer
    from audio_tokens_tpu_torch.train.trainer import Trainer

    calls = _count_plain(monkeypatch)
    k = 3
    cfg = AudioTokensConfig(model_type="lstm", vocab_size=50, num_classes=7,
                            lstm_embed_dim=32, lstm_hidden_dim=128,
                            num_layers=1, max_seq_len=40, dropout=0.1,
                            training_batch_size=8, log_every_steps=0)
    rng = np.random.default_rng(8)
    splits = {}
    for split, n in (("train", 30), ("validation", 12)):
        splits[split] = (rng.integers(0, 50, (32 if n == 30 else 16, 40))
                         .astype(np.uint16),
                         rng.integers(20, 41, 32 if n == 30 else 16)
                         .astype(np.int32),
                         (rng.random((32 if n == 30 else 16, 7)) < 0.3)
                         .astype(np.uint8), n)
    ens = EnsembleTrainer(cfg, cuda_device, seeds=[cfg.random_seed, 5, 6])
    single = device_epoch.DeviceEpochRunner(Trainer(cfg, cuda_device))
    for split, arrays in splits.items():
        ens.set_corpus_arrays(split, *arrays, 8)
        single.set_corpus_arrays(split, *arrays, 8)
    params, opt_state = ens.init_state()
    reads = []
    read = device_epoch.read_scalars

    def let_through(*values):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(read(*values))
        finally:
            torch.cuda.set_sync_debug_mode("error")
        return reads[-1]

    monkeypatch.setattr(device_epoch, "read_scalars", let_through)
    fwd, bwd = lstm_sequence_fwd.launches, lstm_sequence_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt_state, step, losses, per, em = ens.train_epoch(
            params, opt_state, 0, 0)
        va_loss, va_map, va_em = ens.eval_epoch(params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert step == 4 and [len(r) for r in reads] == [2 * k + 1] * 2
    assert lstm_sequence_fwd.launches - fwd == k * (2 * 4 + 2 * 2)
    assert lstm_sequence_bwd.launches - bwd == k * 2 * 4
    assert calls == []
    monkeypatch.setattr(device_epoch, "read_scalars", read)
    _, sloss, smet = single.train_epoch(0, 0)
    sv_loss, sv_met = single.eval_epoch()
    assert losses[0] == pytest.approx(sloss, rel=1e-4)
    assert va_loss[0] == pytest.approx(sv_loss, rel=1e-4)
    assert per[0] == pytest.approx(smet["mAP"], abs=1e-4)
    assert va_map[0] == pytest.approx(sv_met["mAP"], abs=1e-4)
    member = ens.member_params(params, 0)
    for name, p in single.trainer.model.named_parameters():
        torch.testing.assert_close(member[name], p.detach(), rtol=1e-4,
                                   atol=1e-6, msg=name)
