"""The batch-split entry points and the sharded ensemble on four CPU ranks
(gloo; the mesh is the process group), against one process of the port and
the JAX package on the same inputs:

  * ``ServingProgram.serve_sharded`` (lstm, and bert on B5's route) and
    ``FusedTokenizer.tokens_sharded`` (B1's route, the int16 wire, the
    normalized route through B2) at batch 8: every rank returns the whole
    batch, tokens equal to ``serve`` / ``tokens_from_padded`` in one
    process and probabilities within 1e-6 (JAX ``tests/test_export.py:108,
    148``, ``tests/test_sharded_tokenizer.py:12, 35, 49``); the programs
    carry the JAX ``ServingProgram``'s initial weights
    (``convert.state_dict_for``), and every rank's tokens and
    probabilities are held to the JAX program's ``serve`` on the same clips
    too (bert's on the JAX package's plain attention, its route on the
    CPU); the tokens of one process against the JAX tokenizer's at
    near-ties (``ops/vq.check_near_ties``); a batch of 6 refused with the
    JAX message, and the normalized route without lengths;
  * ``EnsembleTrainer(mesh=...)``: 4 lstm members (dropout on) over the 4
    ranks, a training and a validation epoch, against the unsharded
    ensemble at the JAX test's tolerances (``tests/test_ensemble.py:99``:
    rtol 1e-5, atol 1e-6, mAP 2e-6); and a 4-member LR sweep without
    dropout from the JAX ``EnsembleTrainer``'s initial weights
    (``convert.ensemble_state_dicts``, each rank its members' slice),
    every rank's gathered losses and mAP against the JAX ensemble's at the
    same tolerances (JAX's dropout masks are not torch's, hence no dropout
    there).

The ranks run this file as a script (``tests/torch_ranks.py``):

    python tests/test_torch_sharded.py PORT RANK WORLD OUTDIR
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 4
N_CLIPS = 8
VOCAB, N_MELS = 20, 32
AUDIO = dict(common_sr=22050, n_mels=N_MELS, n_fft=256, hop_length=128,
             clip_seconds=1.0, vocab_size=VOCAB, num_classes=7,
             max_seq_len=176, compute_dtype="float32", random_seed=3)
PROGRAMS = {
    "lstm": dict(model_type="lstm", lstm_embed_dim=16, lstm_hidden_dim=24,
                 num_layers=1),
    "bert": dict(model_type="bert", hidden_size=64, num_layers=1,
                 transformer_max_position=176,
                 transformer_attention="flash"),
}
ENS = dict(model_type="lstm", vocab_size=50, num_classes=8, max_seq_len=24,
           training_batch_size=8, lstm_embed_dim=8, lstm_hidden_dim=16,
           num_layers=1, random_seed=11, learning_rate=3e-3, dropout=0.1,
           save_best_checkpoint=False)
ENS_K = 4
SWEEP_LRS = [1e-3, 2e-3, 3e-3, 5e-3]  # the ensemble held to JAX's
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
MAP_ATOL = 2e-6
PROBS_ATOL = 1e-6


def _centroids() -> np.ndarray:
    c = np.random.default_rng(7).standard_normal((VOCAB, N_MELS))
    return (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)


def _program(name: str, weights: dict):
    """The port's program ``name`` with the JAX program's weights."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.export import ServingProgram
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    cfg = AudioTokensConfig(**AUDIO, **PROGRAMS[name])
    return ServingProgram.from_components(
        cfg, FusedTokenizer(cfg, _centroids(), "cpu"), weights[name],
        device="cpu")


def _tokenizer(**over):
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.tokenizer import FusedTokenizer

    return FusedTokenizer(AudioTokensConfig(**AUDIO, **over), _centroids(),
                          "cpu")


def _ensemble(mesh=None, init=None):
    """The ensemble -> (its trainer, (params, opt_state)): the dropout run
    from the port's seeds, or with ``init`` (all K members' stacked
    weights) the LR sweep from them, each rank taking its members' rows."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.train.ensemble import EnsembleTrainer

    if init is None:
        ens = EnsembleTrainer(AudioTokensConfig(**ENS), "cpu",
                              n_models=ENS_K, mesh=mesh)
        return ens, ens.init_state()
    ens = EnsembleTrainer(AudioTokensConfig(**{**ENS, "dropout": 0.0}),
                          "cpu", learning_rates=SWEEP_LRS, mesh=mesh)
    params, opt_state = ens.init_state()
    mine = slice(ens._lo, ens._lo + ens.n_local)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(init[name][mine])
    return ens, (params, opt_state)


def _set_corpus(ens, corpus) -> None:
    for split, n in (("train", 32), ("validation", 16)):
        ens.set_corpus_arrays(split, corpus[f"{split}_x"],
                              corpus[f"{split}_len"], corpus[f"{split}_y"],
                              n_real=n, batch_size=8)


def _ensemble_epochs(ens, state, corpus) -> dict:
    _set_corpus(ens, corpus)
    params, opt_state = state
    params, opt_state, _, loss, per, ens_map = ens.train_epoch(
        params, opt_state, 0, 0)
    v_loss, v_per, v_ens = ens.eval_epoch(params)
    return dict(loss=loss, per=per, ens=ens_map, v_loss=v_loss, v_per=v_per,
                v_ens=v_ens)


def _entry_points(inp: dict, weights: dict, mesh) -> dict:
    """Every batch-split entry point on ``mesh`` (None: one process's
    counterparts)."""
    x, ln = torch.from_numpy(inp["batch"]), torch.from_numpy(inp["lengths"])
    wire = torch.from_numpy(inp["wire"])
    res = {}
    for name in PROGRAMS:
        prog = _program(name, weights)
        out = (prog.serve(x, ln) if mesh is None
               else prog.serve_sharded(x, ln, mesh))
        res[name] = [t.numpy() for t in out]
    tok, norm = _tokenizer(), _tokenizer(normalize=True)
    if mesh is None:
        res["tokens"] = tok.tokens_from_padded(x).numpy()
        res["wire"] = tok.tokens_from_padded(wire).numpy()
        res["normalized"] = norm.tokens_from_padded(x, ln).numpy()
        return res
    res["tokens"] = tok.tokens_sharded(x, mesh).numpy()
    res["wire"] = tok.tokens_sharded(wire, mesh).numpy()
    res["normalized"] = norm.tokens_sharded(x, mesh, ln).numpy()
    for what, call in (
            ("serve_6", lambda: _program("lstm", weights).serve_sharded(
                x[:6], ln[:6], mesh)),
            ("tokens_6", lambda: tok.tokens_sharded(x[:6], mesh)),
            ("no_lengths", lambda: norm.tokens_sharded(x, mesh))):
        try:
            call()
        except ValueError as e:
            res[what] = str(e)
    return res


# -- the ranks ------------------------------------------------------------

def _rank_main(port: str, rank: int, world: int, out: Path) -> None:
    from tests import torch_ranks

    torch_ranks.join(port, rank, world)
    from audio_tokens_tpu_torch.parallel.mesh import DataGroup, make_mesh

    inp = dict(np.load(out / "inputs.npz"))
    weights = torch.load(out / "weights.pt")
    res = _entry_points(inp, weights, make_mesh())
    ens, state = _ensemble(DataGroup())
    res["ensemble"] = _ensemble_epochs(ens, state, inp)
    res["ensemble_local"] = ens.n_local
    ens, state = _ensemble(DataGroup(), weights["sweep"])
    res["sweep"] = _ensemble_epochs(ens, state, inp)
    torch.save(res, out / f"result_{rank}.pt")


# -- the module -------------------------------------------------------------------

def _jax_config(**kw):
    from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig

    return JaxConfig(**kw)


def _jax_programs() -> dict:
    """The JAX ``ServingProgram`` of each family, its initial weights drawn
    from the config's seed (bert on the JAX package's plain attention: the
    route holds no parameter, and it is the one that runs on the CPU)."""
    from audio_tokens_tpu.export import ServingProgram as JaxProgram
    from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer

    import jax

    progs = {}
    for name, kw in PROGRAMS.items():
        cfg = _jax_config(**{**AUDIO, **kw, "transformer_attention": "xla"})
        tok = JaxTokenizer(cfg, _centroids(), use_pallas=False)
        # the program's own init, traced once (eager, it takes seconds)
        params = jax.jit(
            lambda: JaxProgram.from_components(cfg, tok).params)()
        progs[name] = JaxProgram.from_components(cfg, tok, params)
    return progs


def _jax_sweep(corpus: dict):
    """The JAX LR sweep on ``corpus`` -> (it, its initial state)."""
    from audio_tokens_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble

    ens = JaxEnsemble(_jax_config(**{**ENS, "dropout": 0.0}),
                      learning_rates=SWEEP_LRS)
    _set_corpus(ens, corpus)
    return ens, ens.init_state()


def _weights(out: Path, progs: dict, sweep_params) -> dict:
    """The JAX initial weights in the port's layout, for the ranks too."""
    import jax

    from audio_tokens_tpu_torch.convert import (ensemble_state_dicts,
                                                state_dict_for)

    weights = {name: state_dict_for(name, jax.device_get(p.params))
               for name, p in progs.items()}
    weights["sweep"] = ensemble_state_dicts("lstm",
                                            jax.device_get(sweep_params))
    torch.save(weights, out / "weights.pt")
    return weights


def _inputs(out: Path) -> dict:
    from tests import fixtures

    tok = _tokenizer()
    batch, lengths = tok.frontend.prepare_batch(
        [fixtures.synth_clip(i, seconds=0.6) for i in range(N_CLIPS)])
    rng = np.random.default_rng(5)
    inp = dict(batch=batch, lengths=lengths,
               wire=np.clip(np.rint(batch * 32768.0), -32768,
                            32767).astype(np.int16))
    for split, n in (("train", 32), ("validation", 16)):
        inp[f"{split}_x"] = rng.integers(0, 50, (n, 24)).astype(np.uint16)
        inp[f"{split}_len"] = rng.integers(12, 25, n).astype(np.int32)
        y = (rng.random((n, 8)) < 0.3).astype(np.uint8)
        y[0] = 1
        inp[f"{split}_y"] = y
    np.savez(out / "inputs.npz", **inp)
    return inp


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    from tests import torch_ranks

    import jax.numpy as jnp

    out = tmp_path_factory.mktemp("torch_sharded")
    t0 = time.perf_counter()
    inp = _inputs(out)
    progs = _jax_programs()
    jens, (jp, jo) = _jax_sweep(inp)
    weights = _weights(out, progs, jp)
    procs = torch_ranks.start(Path(__file__).resolve(), WORLD, out)
    try:
        one = _entry_points(inp, weights, None)
        ens, state = _ensemble()
        one["ensemble"] = _ensemble_epochs(ens, state, inp)
        ens, state = _ensemble(init=weights["sweep"])
        one["sweep"] = _ensemble_epochs(ens, state, inp)
        jax_ref = {name: [np.asarray(a) for a in p(
            jnp.asarray(inp["batch"]), jnp.asarray(inp["lengths"]))]
            for name, p in progs.items()}
        jax_ref["sweep"] = _ensemble_epochs(jens, (jp, jo), inp)
    finally:
        torch_ranks.finish(procs, out)
    got = [torch.load(out / f"result_{r}.pt", weights_only=False)
           for r in range(WORLD)]  # the ranks' own numpy results
    print(f"four-rank module: {time.perf_counter() - t0:.1f} s")
    return dict(got=got, one=one, inp=inp, jax=jax_ref)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_serve_sharded_is_serve(mp, name):
    tokens, n_valid, probs = mp["one"][name]
    for r, got in enumerate(mp["got"]):
        np.testing.assert_array_equal(got[name][0], tokens, err_msg=f"{r}")
        np.testing.assert_array_equal(got[name][1], n_valid, err_msg=f"{r}")
        np.testing.assert_allclose(got[name][2], probs, rtol=0,
                                   atol=PROBS_ATOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_serve_sharded_matches_jax_serve(mp, name):
    """Every rank's gathered (tokens, n_valid, probs) against the JAX
    ``ServingProgram.serve`` with the same weights on the same clips."""
    tokens, n_valid, probs = mp["jax"][name]
    for r, got in enumerate(mp["got"]):
        np.testing.assert_array_equal(got[name][0], tokens, err_msg=f"{r}")
        np.testing.assert_array_equal(got[name][1], n_valid, err_msg=f"{r}")
        np.testing.assert_allclose(got[name][2], probs, rtol=0,
                                   atol=PROBS_ATOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("what", ["tokens", "wire", "normalized"])
def test_tokens_sharded_is_tokens_from_padded(mp, what):
    for got in mp["got"]:
        np.testing.assert_array_equal(got[what], mp["one"][what])


def test_int16_wire_tokens_as_the_decoded_floats(mp):
    """JAX ``tests/test_sharded_tokenizer.py:49``: the sharded entry point
    decodes the int16 wire as s / 32768 before any compute."""
    wire = mp["inp"]["wire"]
    tok = _tokenizer()
    floats = torch.from_numpy(wire.astype(np.float32) / 32768.0)
    for got in mp["got"]:
        np.testing.assert_array_equal(got["wire"],
                                      tok.tokens_from_padded(floats).numpy())


@pytest.mark.parametrize("normalize", [False, True])
def test_one_process_tokens_match_jax(mp, normalize):
    import jax.numpy as jnp

    from audio_tokens_tpu.config import AudioTokensConfig as JaxConfig
    from audio_tokens_tpu.tokenizer import FusedTokenizer as JaxTokenizer
    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    x = torch.from_numpy(mp["inp"]["batch"])
    ln = torch.from_numpy(mp["inp"]["lengths"])
    jt = JaxTokenizer(JaxConfig(**{k: v for k, v in AUDIO.items()
                                   if k != "compute_dtype"},
                                normalize=normalize),
                      _centroids(), use_pallas=False)
    tok = _tokenizer(normalize=normalize)
    if normalize:
        ref = jt.tokens_from_padded(jnp.asarray(x.numpy()),
                                    jnp.asarray(ln.numpy()))
        feats = tok.frontend.normalized(x, ln).transpose(1, 2)
        got = mp["one"]["normalized"]
    else:
        ref = jt.tokens_from_padded(jnp.asarray(x.numpy()))
        feats = tok.kernel.log_mel_plain(x)
        got = mp["one"]["tokens"]
    check_near_ties(l2_normalize(feats), tok.centroids, torch.from_numpy(got),
                    torch.from_numpy(np.array(ref)))


def test_indivisible_batch_and_missing_lengths_refused(mp):
    for got in mp["got"]:
        assert got["serve_6"] == "batch 6 not divisible by data=4"
        assert got["tokens_6"] == "batch 6 not divisible by data=4"
        assert got["no_lengths"] == "config.normalize=True requires lengths"


def test_sharded_ensemble_is_the_unsharded_one(mp):
    want = mp["one"]["ensemble"]
    for got in mp["got"]:
        assert got["ensemble_local"] == ENS_K // WORLD
        e = got["ensemble"]
        for key in ("loss", "per", "v_loss", "v_per"):
            np.testing.assert_allclose(e[key], want[key], err_msg=key,
                                       **JAX_TOL)
        for key in ("ens", "v_ens"):
            assert e[key] == pytest.approx(want[key], abs=MAP_ATOL)
    # the members differ (seeds), and the ranks agree exactly
    assert len(set(np.round(want["loss"], 6))) == ENS_K
    first = mp["got"][0]["ensemble"]
    for got in mp["got"][1:]:
        for key, v in got["ensemble"].items():
            np.testing.assert_array_equal(v, first[key])


@pytest.mark.parametrize("ref", ["jax", "one"])
def test_sharded_sweep_matches_jax_ensemble(mp, ref):
    """The LR sweep from the JAX ensemble's initial weights, a member a
    rank: every rank's gathered per-member losses and mAP, and the
    ensemble's mAP, against the JAX ``EnsembleTrainer``'s epoch and the
    port's unsharded one."""
    want = mp[ref]["sweep"]
    for r, got in enumerate(mp["got"]):
        e = got["sweep"]
        for key in ("loss", "per", "v_loss", "v_per"):
            np.testing.assert_allclose(e[key], want[key],
                                       err_msg=f"rank {r} {key}", **JAX_TOL)
        for key in ("ens", "v_ens"):
            assert e[key] == pytest.approx(want[key], abs=MAP_ATOL), (r, key)
    # the learning rates differ member by member, so do the losses
    assert len(set(np.round(want["loss"], 6))) == ENS_K


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
               Path(sys.argv[4]))
