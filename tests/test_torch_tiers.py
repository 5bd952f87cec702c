"""The precision tiers of kernels B1 and B2 and of the Lloyd loop, in the
port's plain versions, against the JAX package.

* the bf16x3 product against ``pallas_tokenizer._dot_tier``; the default
  product against ``_dot_tier`` on operands rounded to bf16 first (XLA's
  CPU backend computes ``Precision.DEFAULT`` in f32, where the TPU rounds
  both operands to bf16: the explicit rounding is the TPU's arithmetic);
* the plain tokenizer at each tier against the JAX kernel in interpret
  mode at the same tier (``default`` with ``_dot_tier`` patched, in this
  process only, to round its operands as the TPU does), single-chunk and
  chunked; tokens equal except at the tier's near-ties;
* K-means at ``high`` and ``default`` against a numpy version of the TPU
  arithmetic (``Precision.HIGH``: three bf16 passes; ``DEFAULT``: one), its
  objective against the JAX ``highest`` fit (also at K 600 and d 130, past
  what the tiered kernel once took), and the streaming fit equal to the
  in-memory one at each tier;
* the tiered kernels' launch plan (``cuda_vq.vq_tier_plan``) at the
  package's shapes, and their centroid image (``cuda_vq.tier_image``)
  decoded back into the tier's operands, its c2 k-step summing to -c2 / 2
  exactly, the kernel's arithmetic on it held to the plain tier version.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops import kmeans as jax_km
from audio_tokens_tpu.ops import pallas_tokenizer as jax_pt
from audio_tokens_tpu_torch.ops import kmeans as km
from audio_tokens_tpu_torch.ops.cuda_tokenizer import TokenizerKernel
from audio_tokens_tpu_torch.ops.cuda_vq import (
    MAX_SMEM,
    PAD_SCORE,
    tier_image,
    tier_item_bytes,
    vq_argmin,
    vq_argmin_plain,
    vq_tier_plan,
)
from audio_tokens_tpu_torch.ops.mel import MelFrontend
from audio_tokens_tpu_torch.ops.tiers import (
    check_follows_tier,
    check_tier_ties,
    split_bf16,
    tier_matmul,
)
from audio_tokens_tpu_torch.ops.vq import l2_normalize

DIMS = (((1,), (0,)), ((), ()))
SR, N_MELS, N_FFT, HOP = 22050, 32, 256, 128
FLOOR = {"bf16x3": 0.999, "default": 0.98}  # the JAX tests' agreement floors


def bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def np_parts(x: np.ndarray, tier: str):
    """The tier's operand parts in numpy (ml_dtypes bf16)."""
    hi = bf16(x)
    return (hi, bf16(x - hi)) if tier == "bf16x3" else (hi,)


def np_tier_dot(a: np.ndarray, b: np.ndarray, tier: str) -> np.ndarray:
    """a @ b as the TPU computes it at the tier, in f64 (bf16 products are
    exact; the TPU's f32 accumulation differs at f32 rounding)."""
    ap = [p.astype(np.float64) for p in np_parts(a, tier)]
    bp = [p.astype(np.float64) for p in np_parts(b, tier)]
    if tier == "bf16x3":
        return ap[0] @ bp[0] + (ap[0] @ bp[1] + ap[1] @ bp[0])
    return ap[0] @ bp[0]


def np_lloyd(x: np.ndarray, c: np.ndarray, niter: int, tier: str):
    """The JAX package's Lloyd loop (empty clusters keep their centroid)
    with the TPU's arithmetic at ``tier``: assignment scores ``||c||^2 -
    2 x.c`` at the tier; centroid sums of the rows as the tier's one-hot
    product sees them; the objective the last assignment's min score plus
    ``||x||^2``.  -> (centroids f32, objective, last ids)."""
    c = c.astype(np.float32)
    x2 = float((x.astype(np.float64) ** 2).sum())
    for _ in range(niter):
        c2 = (c.astype(np.float64) ** 2).sum(1)
        scores = c2[None, :] - 2.0 * np_tier_dot(x, c.T, tier)
        ids = scores.argmin(1)
        obj = float(scores.min(1).sum()) + x2
        rows = sum(p.astype(np.float64) for p in np_parts(x, tier))
        sums = np.zeros(c.shape, np.float64)
        np.add.at(sums, ids, rows)
        counts = np.bincount(ids, minlength=len(c)).astype(np.float32)
        sums = sums.astype(np.float32)
        c = np.where(counts[:, None] > 0,
                     sums / np.maximum(counts, 1.0)[:, None], c)
    return c.astype(np.float32), obj, ids


def blobs(seed=0, n=4096, d=16, k=8, spread=2.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    x = centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))
    x = x.astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)].copy()


# ---- the products ---------------------------------------------------------

def test_bf16x3_product_matches_jax_dot_tier():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 96)).astype(np.float32)
    ref = np.asarray(jax_pt._dot_tier(a, b, DIMS, "bf16x3"))
    got = tier_matmul(torch.from_numpy(a), torch.from_numpy(b),
                      "bf16x3").numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-6
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - exact).max() / scale < 2e-5  # the JAX test's bound


def test_default_product_matches_jax_on_rounded_operands():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 96)).astype(np.float32)
    ref = np.asarray(jax_pt._dot_tier(bf16(a), bf16(b), DIMS, "highest"))
    got = tier_matmul(torch.from_numpy(a), torch.from_numpy(b),
                      "default").numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


def test_split_is_the_jax_split():
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    hi, lo = split_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), bf16(x))
    np.testing.assert_array_equal(lo.numpy(), bf16(x - bf16(x)))


@pytest.mark.parametrize("bad", [
    lambda: tier_matmul(torch.ones(2, 2), torch.ones(2, 2), "fp8"),
    lambda: vq_argmin(torch.ones(4, 3), torch.ones(2, 3), False, "tf32"),
    lambda: vq_argmin_plain(torch.ones(4, 3), torch.ones(2, 3), False,
                            tier="high"),
    lambda: TokenizerKernel(SR, 8, 64, 32, 10, np.ones((2, 8), np.float32),
                            "cpu", tier="int8"),
    lambda: TokenizerKernel(SR, 8, 64, 32, 10, np.ones((2, 8), np.float32),
                            "cpu", vq_tier="bf16x6"),
    lambda: km.kmeans_fit(np.ones((8, 2), np.float32), 2, 1, device="cpu",
                          precision="bf16x3"),
])
def test_junk_tiers_raise(bad):
    with pytest.raises(ValueError, match="unknown"):
        bad()


# ---- B1 and B2's plain versions against the JAX kernel ---------------------

def _default_as_on_tpu(monkeypatch):
    """``_dot_tier(..., "default")`` as the TPU computes it: both operands
    rounded to bf16, f32 accumulation (this process only)."""
    orig = jax_pt._dot_tier

    def dot_tier(a, b, dims, tier):
        if tier == "default":
            return orig(a.astype(jax.numpy.bfloat16).astype(jax.numpy.float32),
                        b.astype(jax.numpy.bfloat16).astype(jax.numpy.float32),
                        dims, "highest")
        return orig(a, b, dims, tier)

    monkeypatch.setattr(jax_pt, "_dot_tier", dot_tier)


def _tokens_pair(tier, vq_tier, vocab, chunk, seed=3):
    """(port plain tokens, JAX interpret tokens, port features, centroids,
    the batch) at the tiers."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((vocab, N_MELS)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    fe = MelFrontend("cpu", SR, N_MELS, N_FFT, HOP, SR)
    frames = fe.frames_max
    jk = jax_pt.TokenizerKernel(SR, N_MELS, N_FFT, HOP, frames, cents,
                                tier=tier, vq_tier=vq_tier,
                                k_chunk_cap=chunk, interpret=True)
    if chunk:
        assert jk.n_kc > 1
    # six clips, ~1,000 frames: one flip is 0.1% of them
    clips = [rng.standard_normal(int(SR * s)).astype(np.float32) * a
             for s, a in ((0.9, 1.0), (1.0, 0.05), (1.0, 0.5), (0.8, 2.0),
                          (1.0, 1.0), (0.7, 0.2))]
    batch, _ = fe.prepare_batch(clips)
    wide = np.zeros((len(batch), jk.n_blocks * HOP), np.float32)
    wide[:, :batch.shape[1]] = batch
    ref = np.array(jk(jax.numpy.asarray(wide)))
    pk = TokenizerKernel(SR, N_MELS, N_FFT, HOP, frames, cents, "cpu",
                         tier, vq_tier)
    x = torch.from_numpy(wide)
    got = pk(x)
    assert torch.equal(got, pk.plain(x))
    feats = l2_normalize(pk.log_mel_plain(x))
    return got, torch.from_numpy(ref), feats, pk.centroids, x


@pytest.mark.parametrize("chunk", [None, 128])
@pytest.mark.parametrize("vq_tier", ["bf16x3", "default"])
def test_plain_tokenizer_vq_tier_matches_jax_interpret(vq_tier, chunk):
    """K 300: one chunk, and three 128-wide chunks (the running argmin)."""
    got, ref, feats, cents, x = _tokens_pair("highest", vq_tier, 300, chunk)
    check_tier_ties(feats, cents, got, ref, vq_tier)
    exact = TokenizerKernel(SR, N_MELS, N_FFT, HOP, got.shape[1],
                            cents.numpy(), "cpu")(x)
    assert (got == exact).float().mean() > FLOOR[vq_tier]


@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_plain_tokenizer_dft_tier_matches_jax_interpret(tier, monkeypatch):
    """The DFT and mel products at the tier (the VQ at the same tier)."""
    _default_as_on_tpu(monkeypatch)
    got, ref, feats, cents, x = _tokens_pair(tier, tier, 48, None, seed=4)
    check_tier_ties(feats, cents, got, ref, tier)
    exact = TokenizerKernel(SR, N_MELS, N_FFT, HOP, got.shape[1],
                            cents.numpy(), "cpu")(x)
    assert (got == exact).float().mean() > FLOOR[tier]


@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_plain_log_mel_tier_matches_jax_chain(tier):
    """The features themselves: the port's plain DFT -> power -> mel at the
    tier against the same chain through ``_dot_tier`` (rounded operands
    for default), within the tier's rounding."""
    rng = np.random.default_rng(5)
    fe = MelFrontend("cpu", SR, N_MELS, N_FFT, HOP, SR)
    batch, _ = fe.prepare_batch([rng.standard_normal(SR).astype(np.float32)])
    pk = TokenizerKernel(SR, N_MELS, N_FFT, HOP, fe.frames_max,
                         np.ones((2, N_MELS), np.float32), "cpu", tier)
    x = torch.from_numpy(batch)
    got = pk.log_mel_plain(x).numpy()[0]
    frames = x[0, :pk.padded_len].unfold(0, N_FFT, HOP)[:pk.n_frames].numpy()
    nb = pk.basis.shape[1] // 2

    def dot(a, b):
        if tier == "default":
            return np.asarray(jax_pt._dot_tier(bf16(a), bf16(b), DIMS,
                                               "highest"))
        return np.asarray(jax_pt._dot_tier(a, b, DIMS, tier))

    spec = dot(frames, pk.basis.numpy())
    power = spec[:, :nb] ** 2 + spec[:, nb:] ** 2
    ref = 10.0 * np.log10(np.maximum(dot(power, pk.fbank.numpy()), 1e-10))
    loud = ref > -80.0
    tol = {"bf16x3": 1e-3, "default": 0.2}[tier]  # dB
    assert np.abs(got - ref)[loud].max() < tol


@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_plain_vq_tier_matches_numpy_tier(tier):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    c = rng.standard_normal((500, 64)).astype(np.float32)
    got = vq_argmin(torch.from_numpy(x), torch.from_numpy(c), False, tier)
    scores = ((c.astype(np.float64) ** 2).sum(1)[None, :]
              - 2.0 * np_tier_dot(x, c.T, tier))
    ref = torch.from_numpy(scores.argmin(1))
    check_tier_ties(torch.from_numpy(x), torch.from_numpy(c), got, ref,
                    tier)


def test_tier_checks_refuse_a_float32_answer():
    """The checks the card holds B1 and B2 to catch a kernel that ignored
    ``default`` and computed in f32: its ids (the highest ids) are too many
    apart from the plain default version for the same-tier rule, and keep
    the highest answer where the tier leaves it; the plain default ids
    pass both."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((20000, 64)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((500, 64)).astype(np.float32))
    plain = vq_argmin(x, c, False, "default")
    f32 = vq_argmin(x, c, False)
    assert check_tier_ties(x, c, plain, plain.clone(), "default")[0] == 0.0
    assert check_follows_tier(plain, plain, f32, "default",
                              band=False)[1] == 1.0
    with pytest.raises(AssertionError, match="disagree"):
        check_tier_ties(x, c, f32, plain, "default")
    with pytest.raises(AssertionError, match="take the plain tier"):
        check_follows_tier(f32, plain, f32, "default", band=False)


@pytest.mark.parametrize("moved,ok", [(0, False), (100, True), (300, False)])
def test_default_band_against_highest(moved, ok):
    """At ``default`` the share of ids apart from highest must lie in the
    band read on audio features: 0 (an f32 answer) and 3% fail, 1%
    passes."""
    highest = torch.arange(10000) % 7
    ids = highest.clone()
    ids[:moved] = (ids[:moved] + 1) % 7
    if ok:
        apart, followed = check_follows_tier(ids, ids, highest, "default")
        assert apart == pytest.approx(moved / 10000) and followed == 1.0
    else:
        with pytest.raises(AssertionError, match="outside"):
            check_follows_tier(ids, ids, highest, "default")


# ---- K-means ----------------------------------------------------------------

@pytest.mark.parametrize("precision,tier", [("high", "bf16x3"),
                                            ("default", "default")])
def test_kmeans_tier_matches_numpy_tpu_arithmetic(precision, tier):
    x, init = blobs(seed=7)
    ref_c, ref_obj, ref_ids = np_lloyd(x, init, 10, tier)
    pc, pobj = km.kmeans_fit(torch.from_numpy(x), 8, 10, init_centroids=init,
                             precision=precision)
    np.testing.assert_allclose(pc.numpy(), ref_c, atol=1e-5, rtol=0)
    assert abs(pobj - ref_obj) <= 1e-5 * abs(ref_obj)
    ids = km.assign(torch.from_numpy(x), torch.from_numpy(ref_c), tier)
    check_tier_ties(torch.from_numpy(x), torch.from_numpy(ref_c), ids,
                    torch.from_numpy(np_lloyd(x, ref_c, 1, tier)[2]), tier)
    jc, jobj = jax_km.kmeans_fit(x, 8, 10, init_centroids=init)
    c = pc.numpy().astype(np.float64)
    exact = float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).sum())
    assert abs(exact - jobj) <= 1e-4 * abs(jobj)
    if tier == "bf16x3":
        assert abs(pobj - jobj) <= 1e-4 * abs(jobj)
    # at default the reported objective carries bf16(c)'s rounding, the same
    # for every row of a cluster: 2.5e-3 of it on these blobs, on the TPU too
    # (the numpy reference above computes it so)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
def test_streaming_fit_equals_in_memory_fit_at_each_tier(precision, wire):
    """One super-batch: the streaming fit is the in-memory fit bit for bit
    (of the wire's rows), at each tier."""
    x, init = blobs(seed=8, n=3000)
    rows = x if wire == torch.float32 else bf16(x)
    mc, mobj = km.kmeans_fit(torch.from_numpy(rows), 8, 6,
                             init_centroids=init, precision=precision)
    sc, sobj, n = km.kmeans_fit_streaming(
        lambda: iter([x[:1000], x[1000:]]), 8, 6, d=16, init_centroids=init,
        superbatch_rows=4096, chunk=1024, precision=precision,
        wire_dtype=wire, device="cpu")
    assert n == 3000
    assert torch.equal(sc, mc) and sobj == mobj


@pytest.mark.parametrize("precision", ["high", "default"])
def test_kmeans_class_trains_at_the_tier(precision):
    x, init = blobs(seed=9)
    kmeans = km.KMeans(16, 8, niter=5, precision=precision, device="cpu")
    obj = kmeans.train(x, init_centroids=init)
    ref_c, ref_obj, _ = np_lloyd(x, init, 5, km.precision_from_str(precision))
    np.testing.assert_allclose(kmeans.centroids.numpy(), ref_c, atol=1e-5,
                               rtol=0)
    assert abs(obj - ref_obj) <= 1e-5 * abs(ref_obj)


@pytest.mark.parametrize("precision,tier", [("high", "bf16x3"),
                                            ("default", "default")])
def test_kmeans_tier_wide_matches_numpy_tpu_arithmetic(precision, tier):
    """K 600 at d 130: more centroids and wider rows than the kernel's
    mma.sync design took at these tiers."""
    x, init = blobs(seed=10, n=6000, d=130, k=600)
    ref_c, ref_obj, _ = np_lloyd(x, init, 4, tier)
    pc, pobj = km.kmeans_fit(torch.from_numpy(x), 600, 4, init_centroids=init,
                             precision=precision)
    np.testing.assert_allclose(pc.numpy(), ref_c, atol=1e-5, rtol=0)
    assert abs(pobj - ref_obj) <= 1e-5 * abs(ref_obj)
    jc, jobj = jax_km.kmeans_fit(x, 600, 4, init_centroids=init)
    # the JAX fit (highest) on the CPU: at bf16x3 the same assignments, so
    # the same centroids up to the rows' rounding (~16 bits) and the same
    # objective; default's 8 bits move 3% of these rows to other clusters,
    # so only its objective is held, within 1%
    if tier == "bf16x3":
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-4,
                                   rtol=0)
    assert abs(pobj - jobj) <= {"bf16x3": 1e-5, "default": 1e-2}[tier] * \
        abs(jobj)


# ---- the tiered kernels' plan and centroid image ----------------------------

@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("d", [12, 64, 100, 128, 130, 640])
@pytest.mark.parametrize("k", [1, 500, 1100, 16384])
def test_vq_tier_plan_takes_every_shape(k, d, tier):
    """B2's plan at the package's shapes: an instance by the width, the
    chunks resident or a ring of at least two stages, within the card's
    shared memory; none refused."""
    plan = vq_tier_plan(k, d, tier)
    ks = -(-d // 16)
    assert (plan.ks, plan.nc, plan.wide) == ((4, 128, 0) if ks <= 4 else
                                             (8, 64, int(ks > 8)))
    assert plan.slices * 16 * plan.ks >= d and plan.chunks * plan.nc >= k
    assert plan.items == plan.chunks * plan.slices
    assert plan.ibytes == tier_item_bytes(plan.nc, plan.ks,
                                          tier == "bf16x3", True)
    assert plan.resident or plan.stages >= 2
    assert not plan.resident or plan.stages == plan.items
    assert plan.smem <= MAX_SMEM
    if k * d <= 1100 * 130:
        c = torch.ones((k, d))
        assert tier_image(c, tier, plan.nc, plan.ks, True).numel() == \
            plan.items * plan.ibytes


def decode_image(img, k, d, tier, chunk, ks, c2_step):
    """tier_image's bytes -> (planes (P, K', d') f32, c2 part): the c2
    k-step's 16 values a centroid (P, K', 16), or the f32 c2 (K',)."""
    planes = 2 if tier == "bf16x3" else 1
    chunks, slices = -(-k // chunk), -(-d // (16 * ks))
    kb = 2 * ks + (2 if c2_step else 0)
    item = tier_item_bytes(chunk, ks, tier == "bf16x3", c2_step)
    raw = img.reshape(chunks, slices, item)
    core = raw[..., :planes * chunk * kb * 8 * 2].contiguous().view(
        torch.bfloat16).float()
    core = core.reshape(chunks, slices, planes, chunk // 8, kb, 8, 8)
    core = core.permute(2, 0, 3, 5, 1, 4, 6)  # (P, chunks, g8, r, slices, kb, e)
    feats = core[..., :2 * ks, :].reshape(planes, chunks * chunk, -1)
    if c2_step:
        return feats, core[:, :, :, :, 0, 2 * ks:, :].reshape(
            planes, chunks * chunk, 16)
    c2 = raw[:, 0, planes * chunk * kb * 16:].contiguous().view(
        torch.float32).reshape(-1)
    return feats, c2


@pytest.mark.parametrize("c2_step", [True, False])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_tier_image_decodes_to_the_tier_operands(tier, c2_step):
    """The image holds the tier's bf16 operands of the centroids, zeros
    past K and d, and c2 as the kernel reads it; the kernel's arithmetic on
    it (f.c - c2 / 2, the largest, the lowest index on ties) holds to the
    plain tier version."""
    rng = np.random.default_rng(11)
    k, d, chunk, ks = 300, 70, 128, 4
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    feats, c2part = decode_image(tier_image(c, tier, chunk, ks, c2_step), k,
                                 d, tier, chunk, ks, c2_step)
    parts = split_bf16(c) if tier == "bf16x3" else (bf16(c.numpy()),)
    for got, want in zip(feats, parts):
        assert torch.equal(got[:k, :d], torch.as_tensor(want))
    assert (feats[:, k:] == 0).all() and (feats[:, :, d:] == 0).all()
    c2 = (c * c).sum(1)
    if c2_step:
        half = c2part[0, :, :3].double().sum(1)
        assert torch.equal(half[:k], -0.5 * c2.double())
        assert (half[k:] == PAD_SCORE).all()
        assert (c2part[0, :, 3:] == 0).all() and (c2part[1:] == 0).all()
    else:
        assert torch.equal(c2part[:k], c2)
        assert torch.isinf(c2part[k:]).all()
        half = -0.5 * c2part.double()
    x = torch.from_numpy(rng.standard_normal((3000, d)).astype(np.float32))
    xp = [p.double() for p in (split_bf16(x) if tier == "bf16x3"
                               else (torch.as_tensor(bf16(x.numpy())),))]
    fp = [f[:, :d].double() for f in feats]
    fc = (xp[0] @ fp[0].T + (xp[0] @ fp[1].T + xp[1] @ fp[0].T)
          if tier == "bf16x3" else xp[0] @ fp[0].T)
    ids = (fc + half[None, :]).argmax(1)
    check_tier_ties(x, c, ids, vq_argmin_plain(x, c, False, tier=tier), tier)
