"""Kernel B2's plain version (and the port's vq module) vs the JAX package:
the Pallas kernel run in interpret mode and the chunked XLA ``vq_assign``.
Ids must be equal except at near-ties (ops/vq.check_near_ties: at most
0.1% of rows, each with a float64 score gap below 1e-4)."""

import numpy as np
import pytest
import torch

from audio_tokens_tpu.ops import vq as jax_vq
from audio_tokens_tpu.ops.pallas_vq import vq_assign_pallas
from audio_tokens_tpu_torch.ops import vq
from audio_tokens_tpu_torch.ops.cuda_vq import vq_argmin, vq_argmin_plain


def _data(rng, n=700, d=32, k=300):
    x = rng.standard_normal((n, d)).astype(np.float32) * 3.0
    c = rng.standard_normal((k, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return x, c


@pytest.mark.parametrize("normalize", [False, True])
def test_plain_matches_pallas_interpret(rng, normalize):
    x, c = _data(rng)
    ref = np.asarray(vq_assign_pallas(x, c, normalize=normalize,
                                      interpret=True))
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = vq_argmin(xt, ct, normalize)  # CPU tensor: the plain version
    assert got.dtype == torch.int32
    feats = vq.l2_normalize(xt) if normalize else xt
    vq.check_near_ties(feats, ct, got, torch.tensor(ref))


@pytest.mark.parametrize("normalize", [False, True])
def test_fused_router_matches_jax_vq_assign(rng, normalize):
    x, c = _data(rng, n=1500, d=16, k=40)
    xj = np.asarray(jax_vq.l2_normalize(x)) if normalize else x
    ref = jax_vq.vq_assign(xj, c, chunk=512)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = vq.vq_assign_fused(xt, ct, normalize=normalize)
    feats = vq.l2_normalize(xt) if normalize else xt
    vq.check_near_ties(feats, ct, got, torch.tensor(ref))


def test_vq_assign_chunked_matches_jax(rng):
    x, c = _data(rng, n=1000, d=16, k=64)
    ref = jax_vq.vq_assign(x, c, chunk=256)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = vq.vq_assign(xt, ct, chunk=300)
    vq.check_near_ties(xt, ct, got, torch.tensor(ref))
    # chunking is exact: rows are independent
    np.testing.assert_array_equal(vq.vq_assign(xt, ct, chunk=None).numpy(),
                                  got.numpy())


def test_l2_normalize_matches_jax(rng):
    x = rng.standard_normal((50, 24)).astype(np.float32)
    np.testing.assert_allclose(vq.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_vq.l2_normalize(x)),
                               rtol=1e-6, atol=1e-7)


def test_ties_break_to_lowest_index():
    """Duplicate centroids score exactly equal: the lower index wins, as in
    jnp.argmin and the kernels' lexicographic merge."""
    c = np.eye(4, dtype=np.float32)[[0, 1, 1, 2, 3, 3]]
    x = np.eye(4, dtype=np.float32)
    got = vq_argmin_plain(torch.from_numpy(x), torch.from_numpy(c), False)
    ref = np.asarray(vq_assign_pallas(x, c, interpret=True))
    np.testing.assert_array_equal(got.numpy(), [0, 1, 3, 4])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_check_near_ties_rejects_real_disagreement(rng):
    x, c = _data(rng, n=200, d=8, k=16)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    ids = vq_argmin_plain(xt, ct, False)
    assert vq.check_near_ties(xt, ct, ids, ids.clone()) == (0.0, 0.0)
    wrong = ids.clone()
    wrong[0] = (wrong[0] + 1) % 16
    with pytest.raises(AssertionError, match="disagree"):
        vq.check_near_ties(xt, ct, ids, wrong)
