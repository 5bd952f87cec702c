"""Two ranks of the port on the CPU (``torch.distributed`` over gloo, one
process each, through ``parallel/distributed.maybe_initialize`` and the
``AUDIO_TOKENS_*`` variables) against the JAX package in one process, on
the same inputs:

  A. ``Trainer.run()`` data parallel, streaming, lstm and simple, from the
     JAX init (``convert.state_dict_for``): epoch losses and mAP; the ranks
     start from rank 0's weights; only rank 0 writes the history and the
     checkpoint;
  B. device-resident epochs data parallel, exact and binned mAP;
  C. ``kmeans_fit_streaming`` over the ranks' shards through the disk
     spill, with a given init and with rank 0's drawn and broadcast;
  D. the spectrogram and tokenize stages, clips sharded over the ranks;
  E. the whole pipeline in ``kmeans_mode="full"`` (clustering, tokenize,
     training) on D's workspace; ``batch_warm_start`` refused.

Tolerances (the JAX package's two-process test's): losses 1e-4 relative
plus 1e-5 absolute, mAP 1e-3, centroids 2e-4; tokens equal but at near-ties
(``ops/vq.check_near_ties``); spectrograms atol 5e-3, rtol 1e-4
(``test_torch_pipeline.py``'s).  The two ranks agree exactly.

The ranks run this file as a script:

    python tests/test_torch_multiprocess.py PORT RANK WORLD OUTDIR

reading ``OUTDIR/configs.json`` and the inputs the module fixture wrote,
and writing ``OUTDIR/result_<rank>.npz``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
WAIT_S = 300  # each rank's wait; both are killed past it
GROUP_TIMEOUT_S = 60  # a collective or barrier that waits longer fails
MODELS = ("lstm", "simple")
TRAIN = ("a_lstm", "a_simple", "b_exact", "b_binned", "e_full")
LOSS_RTOL, LOSS_ATOL, MAP_ATOL, CENT_TOL = 1e-4, 1e-5, 1e-3, 2e-4
KM_K, KM_D, KM_N, KM_FEED = 8, 16, 4096, 300


# -- the inputs, shared by the ranks and the references ---------------------

def _kmeans_corpus():
    """The JAX two-process test's blobs and init."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((KM_K, KM_D)).astype(np.float32) * 5
    idx = rng.integers(0, KM_K, KM_N)
    x = (centers[idx] + 0.1 * rng.standard_normal((KM_N, KM_D))).astype(
        np.float32)
    init = x[rng.choice(KM_N, KM_K, replace=False)].copy()
    return x, init


def _tok_workspace(ws: Path) -> None:
    """Spectrograms and centroids for the tokenize stage (the JAX test's)."""
    n_mels = 16
    rng = np.random.default_rng(11)
    cents = rng.standard_normal((8, n_mels)).astype(np.float32)
    for split in ("train", "validation"):
        (ws / "spectrograms" / split).mkdir(parents=True)
    for i in range(9):
        np.save(ws / "spectrograms" / "train" / f"clip{i:03d}.npy",
                rng.standard_normal((n_mels, 20 + 3 * i)).astype(np.float32))
    np.save(ws / "spectrograms" / "validation" / "vclip.npy",
            rng.standard_normal((n_mels, 25)).astype(np.float32))
    (ws / "output").mkdir()
    np.save(ws / "output" / "centroids.npy", cents)


def _jax_config(name: str, out: Path, ws: Path = None, ckpt: Path = None):
    """The JAX config of run ``name``; ``ws`` and ``ckpt`` move its
    workspace and checkpoint dir (a config derives its paths once)."""
    from audio_tokens_tpu.config import AudioTokensConfig
    from tests import fixtures, token_corpus

    if name[:2] in ("a_", "b_"):
        kw = dict(epochs=2, checkpoint_dir=str(ckpt or out / f"ckpt_{name}"))
        if name[:2] == "a_":
            kw.update(model_type=name[2:], save_best_checkpoint=True)
        else:
            kw.update(model_type="lstm", device_corpus="on",
                      device_map_bins=0 if name == "b_exact" else 64)
        return token_corpus.config(out / "tokens", **kw)
    if name == "d_tok":
        return AudioTokensConfig(
            base_dir=str(ws or out / "tok_ws"), n_mels=16, vocab_size=8,
            incremental=False, device_batch_size=4, use_convolution=False)
    ws = ws or out / "spec_ws"
    if name == "d_spec":
        return fixtures.test_config(ws, dataset_ratio=1.0,
                                    audio_backend="python")
    return fixtures.test_config(  # e_full
        ws, dataset_ratio=1.0, audio_backend="python", kmeans_mode="full",
        kmeans_streaming="always", kmeans_superbatch_rows=1024,
        kmeans_stream_spill_mb=16, model_type="simple", epochs=2,
        training_batch_size=4, save_best_checkpoint=False, num_workers=2)


def _prepare(out: Path) -> dict:
    """Write the corpora, the workspaces, the JAX init weights of every
    training run and ``configs.json``; -> the JAX configs by name."""
    import jax
    import torch

    from audio_tokens_tpu.data.datasets import DataLoaderCreator
    from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu.data.splitter import DatasetSplitter
    from audio_tokens_tpu.train.trainer import Trainer
    from audio_tokens_tpu_torch.convert import state_dict_for
    from tests import fixtures, token_corpus

    token_corpus.make_token_corpus(out / "tokens")
    _tok_workspace(out / "tok_ws")
    fixtures.make_workspace(out / "spec_ws", n_clips=8)
    cfgs = {name: _jax_config(name, out) for name in (
        "a_lstm", "a_simple", "b_exact", "b_binned", "d_tok", "d_spec",
        "e_full")}
    spec = cfgs["d_spec"]
    DatasetSplitter(spec).create_split_file(AudiosetMetadataProcessor(spec))
    shutil.copytree(out / "spec_ws", out / "jax_spec_ws")  # before any stage
    for name in TRAIN:  # the init Trainer.run() draws, as the port's weights
        jcfg = cfgs[name]
        params, _ = Trainer(jcfg)._init_state(
            DataLoaderCreator(jcfg).get_dataloaders()[0])
        torch.save(state_dict_for(jcfg.model_type, jax.device_get(params)),
                   out / f"init_{name}.pt")
    (out / "configs.json").write_text(json.dumps(
        {k: v.to_dict() for k, v in cfgs.items()}))
    return cfgs


# -- the JAX references -------------------------------------------------------

def _jax_epochs(jcfg):
    """JAX ``Trainer.run()`` -> [(train loss, train mAP, val loss, val
    mAP)] an epoch."""
    from audio_tokens_tpu.train.trainer import Trainer

    seen = []
    t = Trainer(jcfg)
    log = t._log_epoch_results

    def record(epoch, tl, tm, vl, vm, seconds):
        seen.append((tl, tm["mAP"], vl, vm["mAP"]))
        log(epoch, tl, tm, vl, vm, seconds)

    t._log_epoch_results = record
    t.run()
    return np.asarray(seen, np.float64)


def _references(out: Path, cfgs: dict) -> dict:
    """The JAX runs that need nothing of the ranks (made while they run)."""
    from audio_tokens_tpu.ops.kmeans import kmeans_fit_streaming
    from audio_tokens_tpu.processors.spec_tokenizer import SpecTokenizer
    from audio_tokens_tpu.processors.spectrogram_generator import (
        SpectrogramGenerator,
    )

    refs = {}
    for name in ("a_lstm", "a_simple", "b_exact", "b_binned"):
        refs[name] = _jax_epochs(_jax_config(
            name, out, ckpt=out / f"jax_ckpt_{name}"))
    x, init = _kmeans_corpus()
    feeds = [x[i : i + 600] for i in range(0, len(x), 600)]
    refs["c_kmeans"] = [kmeans_fit_streaming(
        lambda: iter(feeds), KM_K, niter=niter, d=KM_D, init_centroids=init,
        superbatch_rows=1024, chunk=128) for niter in (1, 3)]
    tok_ws = out / "jax_tok_ws"
    _tok_workspace(tok_ws)
    SpecTokenizer(_jax_config("d_tok", out, ws=tok_ws)).run()
    refs["d_tok"] = tok_ws
    spec_ws = out / "jax_spec_ws"
    SpectrogramGenerator(_jax_config("d_spec", out, ws=spec_ws)).run()
    refs["d_spec"] = spec_ws
    return refs


def _pipeline_references(out: Path, cfgs: dict) -> dict:
    """The JAX stages on the ranks' artifacts: the full fit on their
    spectrograms, the tokens of their centroids, training on their tokens
    (each stage's inputs are the ranks')."""
    from audio_tokens_tpu.processors.cluster_creator import ClusterCreator
    from audio_tokens_tpu.processors.spec_tokenizer import SpecTokenizer

    ws = out / "jax_e_ws"
    shutil.copytree(out / "spec_ws", ws)
    jcfg = _jax_config("e_full", out, ws=ws)
    cents_path = Path(jcfg.centroids_path)
    port_cents = np.load(cents_path)
    port_tokens = ws / "tokenized_audio"
    shutil.move(port_tokens, ws / "port_tokens")
    refs = {"e_centroids": np.asarray(ClusterCreator(jcfg).run())}
    np.save(cents_path, port_cents)
    SpecTokenizer(jcfg).run()
    refs["e_tokens"] = _token_files(port_tokens, "train")
    shutil.rmtree(port_tokens)
    shutil.move(ws / "port_tokens", port_tokens)
    refs["e_train"] = _jax_epochs(jcfg)
    return refs


# -- the module fixture -----------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _token_files(root: Path, split: str) -> dict:
    return {f.stem: np.load(f) for f in sorted((root / split).glob("*.npy"))}


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_mp")
    t0 = time.perf_counter()
    cfgs = _prepare(out)
    port = _free_port()
    env = dict(os.environ)
    for k in ("AUDIO_TOKENS_COORDINATOR", "AUDIO_TOKENS_NUM_PROCESSES",
              "AUDIO_TOKENS_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    logs = [out / f"rank_{r}.log" for r in range(WORLD)]
    procs = []
    for r in range(WORLD):
        # output to files, not pipes: a full pipe would block a rank
        # inside a collective and hang both
        with open(logs[r], "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(port),
                 str(r), str(WORLD), str(out)],
                cwd=REPO, env=env, stdout=log_f, stderr=subprocess.STDOUT))
    try:
        refs = _references(out, cfgs)
        deadline = time.monotonic() + WAIT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} exited {p.returncode}:\n{logs[r].read_text()[-4000:]}")
    got = {r: dict(np.load(out / f"result_{r}.npz")) for r in range(WORLD)}
    refs.update(_pipeline_references(out, cfgs))
    print(f"two-rank module: {time.perf_counter() - t0:.1f} s")
    return dict(got=got, refs=refs, out=out, cfgs=cfgs)


def _same_on_both(got: dict, key: str) -> np.ndarray:
    np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    return got[0][key]


def _assert_epochs(got: np.ndarray, ref: np.ndarray) -> None:
    """[(train loss, train mAP, val loss, val mAP)] an epoch."""
    assert got.shape == ref.shape
    for col, what in ((0, "train loss"), (2, "val loss")):
        np.testing.assert_allclose(got[:, col], ref[:, col], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=what)
    np.testing.assert_allclose(got[:, [1, 3]], ref[:, [1, 3]], rtol=0,
                               atol=MAP_ATOL)


# -- A. the streaming data-parallel trainer -----------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_two_ranks_train_as_the_jax_trainer(mp, model):
    name = f"a_{model}"
    _assert_epochs(_same_on_both(mp["got"], f"{name}_epochs"),
                   mp["refs"][name])
    _same_on_both(mp["got"], f"{name}_weights")
    # rank 0 alone writes: one history line an epoch, one checkpoint
    ckpt = mp["out"] / f"ckpt_{name}"
    lines = (ckpt / "no-wandb-metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1]
    assert (ckpt / "no-wandb-best" / "params.pt").exists()


def test_two_ranks_start_from_rank_0s_weights(mp):
    """Ranks built with other seeds hold rank 0's init after the
    Trainer's broadcast."""
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.train.trainer import Trainer

    got = _same_on_both(mp["got"], "broadcast")
    cfg = AudioTokensConfig(**{**mp["cfgs"]["a_simple"].to_dict(),
                               "random_seed": 100})
    own = Trainer(cfg, "cpu").model.state_dict()
    np.testing.assert_array_equal(
        got, torch.cat([v.reshape(-1) for v in own.values()]).numpy())


# -- B. device-resident epochs --------------------------------------------------

@pytest.mark.parametrize("metric", ["exact", "binned"])
def test_two_ranks_device_epochs_as_the_jax_runner(mp, metric):
    name = f"b_{metric}"
    _assert_epochs(_same_on_both(mp["got"], f"{name}_epochs"),
                   mp["refs"][name])
    _same_on_both(mp["got"], f"{name}_weights")


# -- C. the streaming K-means fit ------------------------------------------------

def test_two_ranks_stream_kmeans_through_the_spill(mp):
    """Every iteration's centroids equal one process's fit of the same
    corpus (the ranks' f64 sums are only regrouped); against the JAX fit
    the first iteration within 2e-4 and the objective within 1e-6
    relative (4.4e-7 read on the CPU).  Later iterations part from the JAX
    fit's at ties of the f32 assignment on these blobs (ROADMAP C6; pinned
    by ``test_streaming_fit_parts_from_f64_lloyd_only_at_f32_ties``)."""
    from audio_tokens_tpu_torch.ops.kmeans import kmeans_fit_streaming

    got = mp["got"]
    history = _same_on_both(got, "c_history")
    obj = float(_same_on_both(got, "c_obj"))
    assert int(_same_on_both(got, "c_n")) == KM_N
    np.testing.assert_array_equal(history[-1],
                                  _same_on_both(got, "c_centroids"))
    assert not _same_on_both(got, "c_spill_left")  # each rank's file is gone
    x, init = _kmeans_corpus()
    one = []
    kmeans_fit_streaming(
        lambda: iter([x]), KM_K, niter=3, d=KM_D, init_centroids=init,
        superbatch_rows=1024, chunk=128, device="cpu",
        checkpoint_fn=lambda it, c, o: one.append(c.numpy().copy()))
    np.testing.assert_array_max_ulp(history, np.stack(one), maxulp=1)
    (first, _, _), (_, ref_obj, ref_n) = mp["refs"]["c_kmeans"]
    assert ref_n == KM_N
    np.testing.assert_allclose(history[0], np.asarray(first), rtol=CENT_TOL,
                               atol=CENT_TOL)
    assert abs(obj - ref_obj) / abs(ref_obj) < 1e-6


def _f32_ties(scores64: np.ndarray, picked: np.ndarray,
              best: np.ndarray) -> np.ndarray:
    """Rows where ``picked`` is not the f64 argmin ``best``, with their
    f64 score gap in f32 ulps of the score (4 or fewer: a tie that the
    f32 evaluation of ``||c||^2 - 2 x.c`` may break either way)."""
    rows = np.flatnonzero(picked != best)
    gap = scores64[rows, picked[rows]] - scores64[rows, best[rows]]
    return gap / np.spacing(np.abs(scores64[rows, best[rows]]).astype(
        np.float32))


def test_streaming_fit_parts_from_f64_lloyd_only_at_f32_ties():
    """ROADMAP C6: on the JAX two-process test's blobs the port's
    assignment, pass by pass on the port's own centroids, is an f64
    Lloyd's but at f32 ties, and where it parts from the JAX formula's
    (``jnp.dot`` at HIGHEST) on the same centroids both sides are at an
    f32 tie."""
    import jax
    import jax.numpy as jnp
    import torch

    from audio_tokens_tpu_torch.ops.kmeans import (assign,
                                                   kmeans_fit_streaming)

    x, init = _kmeans_corpus()
    history = []
    kmeans_fit_streaming(
        lambda: iter([x]), KM_K, niter=3, d=KM_D, init_centroids=init,
        superbatch_rows=1024, chunk=128, device="cpu",
        checkpoint_fn=lambda it, c, o: history.append(c.numpy().copy()))
    x64 = x.astype(np.float64)
    parted = []
    for c in [init] + history[:-1]:  # the centroids each pass assigns to
        c64 = c.astype(np.float64)
        s64 = (c64 * c64).sum(1)[None] - 2.0 * x64 @ c64.T
        best = s64.argmin(1)
        port = assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
        cj = jnp.asarray(c)
        ref = np.asarray(jnp.argmin(jnp.sum(cj * cj, 1)[None] - 2.0 * jnp.dot(
            jnp.asarray(x), cj.T, precision=jax.lax.Precision.HIGHEST), 1))
        for picked in (port, ref):
            ulps = _f32_ties(s64, picked, best)
            assert np.all(ulps <= 4), ulps
        parted.append(int((port != best).sum()))
    # a few ties in all (2 in pass 2 on the CPU; the JAX fit's own
    # centroids, from f32 sums, happen to meet none)
    assert parted[0] == 0 and sum(parted) <= 4, parted


def test_two_ranks_refuse_a_short_rank_0(mp):
    """Rank 0 holding fewer than k points refuses the drawn init on every
    rank (no rank left waiting)."""
    assert _same_on_both(mp["got"], "c_few_refused")


def test_two_ranks_kmeans_init_is_rank_0s_draw(mp):
    """Without an init, rank 0 draws from its first super-batch and
    broadcasts it: the fit equals one process's from that draw."""
    from audio_tokens_tpu_torch.ops.kmeans import kmeans_fit_streaming

    x, _ = _kmeans_corpus()
    first = x[0::WORLD][:1024]  # rank 0's shard, one super-batch
    init = first[np.random.default_rng(1234).choice(1024, KM_K,
                                                    replace=False)]
    c, _, _ = kmeans_fit_streaming(
        lambda: iter([x]), KM_K, niter=3, d=KM_D, init_centroids=init,
        superbatch_rows=1024, chunk=128, device="cpu")
    np.testing.assert_allclose(_same_on_both(mp["got"], "c_drawn"),
                               c.numpy(), rtol=0, atol=1e-6)


# -- D. the sharded stages -----------------------------------------------------------

def test_two_ranks_spectrogram_stage_as_jax(mp):
    """Every clip once, rendered by its rank, equal to the JAX stage's."""
    got_root = Path(mp["cfgs"]["d_spec"].dest_spec_path)
    ref_root = Path(_jax_config("d_spec", mp["out"],
                                ws=mp["refs"]["d_spec"]).dest_spec_path)
    assert _same_on_both(mp["got"], "d_spec_seen").sum() > 0
    for split in ("train", "validation"):
        ref = _token_files(ref_root, split)
        got = _token_files(got_root, split)
        assert sorted(got) == sorted(ref) and got
        for stem, r in ref.items():
            np.testing.assert_allclose(got[stem], r, atol=5e-3, rtol=1e-4,
                                       err_msg=stem)


def _assert_tokens(got: dict, ref: dict, frames: dict, cents) -> None:
    """Equal token files, but at near-ties of the unit frames."""
    import torch

    from audio_tokens_tpu_torch.ops.vq import check_near_ties, l2_normalize

    assert sorted(got) == sorted(ref) and got
    x = np.concatenate([frames[s] for s in sorted(ref)])
    a = np.concatenate([got[s] for s in sorted(ref)])
    b = np.concatenate([ref[s] for s in sorted(ref)])
    if not np.array_equal(a, b):
        check_near_ties(l2_normalize(torch.from_numpy(x)),
                        torch.from_numpy(cents), torch.from_numpy(a),
                        torch.from_numpy(b))


def test_two_ranks_tokenize_stage_as_jax(mp):
    cfg = mp["cfgs"]["d_tok"]
    ws = Path(cfg.base_dir)
    ref_ws = mp["refs"]["d_tok"]
    spec = _token_files(ws / "spectrograms", "train")
    _assert_tokens(_token_files(ws / "tokenized_audio", "train"),
                   _token_files(ref_ws / "tokenized_audio", "train"),
                   {s: v.T for s, v in spec.items()},
                   np.load(cfg.centroids_path))
    stats = _same_on_both(mp["got"], "d_tok_stats")
    n = sum(v.shape[1] for v in spec.values())
    assert stats.tolist() == [n, np.unique(np.concatenate(
        list(_token_files(ws / "tokenized_audio", "train").values()))).size]
    # rank 0's ledger counts every rank's tokens
    ledger = np.load(ws / "tokenized_audio" / "train.token_counts.npz")
    assert int(ledger["counts"].sum()) == n


# -- E. the whole pipeline -------------------------------------------------------------

def test_two_ranks_run_the_pipeline_in_full_mode(mp):
    got, refs = mp["got"], mp["refs"]
    cfg = mp["cfgs"]["e_full"]
    cents = _same_on_both(got, "e_centroids")
    np.testing.assert_allclose(cents, refs["e_centroids"], rtol=CENT_TOL,
                               atol=CENT_TOL)
    np.testing.assert_array_equal(cents, np.load(cfg.centroids_path))
    spec = _token_files(Path(cfg.dest_spec_path), "train")
    toks = _token_files(Path(cfg.dest_tokenized_path), "train")
    assert len(toks) == len(spec) == _same_on_both(got, "e_n_tokens")
    _assert_tokens(toks, refs["e_tokens"],
                   {s: v.T for s, v in spec.items()}, cents)
    _assert_epochs(_same_on_both(got, "e_train_epochs"), refs["e_train"])
    assert not list((Path(cfg.base_dir) / "output").glob("*spill*"))


def test_two_ranks_refuse_batch_warm_start(mp):
    assert _same_on_both(mp["got"], "e_warm_start_refused")


# -- the rank ------------------------------------------------------------------------------

def _flat(model) -> np.ndarray:
    import torch

    return torch.cat([v.reshape(-1) for v in
                      model.state_dict().values()]).numpy().copy()


def _port_epochs(trainer) -> list:
    seen = []
    log = trainer._log_epoch_results

    def record(epoch, tl, tm, vl, vm, seconds):
        seen.append((tl, tm["mAP"], vl, vm["mAP"]))
        log(epoch, tl, tm, vl, vm, seconds)

    trainer._log_epoch_results = record
    return seen


def _rank_main(port: str, rank: int, world: int, out: Path) -> None:
    import logging
    from datetime import timedelta

    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {rank} %(name)s %(message)s")
    os.environ["AUDIO_TOKENS_COORDINATOR"] = f"localhost:{port}"
    os.environ["AUDIO_TOKENS_NUM_PROCESSES"] = str(world)
    os.environ["AUDIO_TOKENS_PROCESS_ID"] = str(rank)
    sys.path.insert(0, str(REPO))
    import torch

    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.ops.kmeans import kmeans_fit_streaming
    from audio_tokens_tpu_torch.parallel import distributed
    from audio_tokens_tpu_torch.parallel.mesh import data_group
    from audio_tokens_tpu_torch.processors import (
        ClusterCreator,
        ModelTrainer,
        SpecTokenizer,
        SpectrogramGenerator,
    )
    from audio_tokens_tpu_torch.train.trainer import Trainer

    assert distributed.maybe_initialize(
        None, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    assert distributed.maybe_initialize(None)  # the group is taken as it is
    assert (distributed.process_index(), distributed.process_count()) == (
        rank, world)
    assert distributed.backend() == "gloo"
    cfgs = {k: AudioTokensConfig(**v) for k, v in json.loads(
        (out / "configs.json").read_text()).items()}
    res = {}

    def train(name, trainer):
        trainer.model.load_state_dict(torch.load(out / f"init_{name}.pt"))
        epochs = _port_epochs(trainer)
        trainer.run()
        res[f"{name}_epochs"] = np.asarray(epochs, np.float64)
        res[f"{name}_weights"] = _flat(trainer.model)

    # A, B: the trainer, streaming and device-resident
    for name in ("a_lstm", "a_simple", "b_exact", "b_binned"):
        trainer = Trainer(cfgs[name], "cpu")
        assert trainer.dp is not None and trainer.dp.size == world
        train(name, trainer)
    seeded = AudioTokensConfig(**{**cfgs["a_simple"].to_dict(),
                                  "random_seed": 100 + rank})
    res["broadcast"] = _flat(Trainer(seeded, "cpu").model)

    # C: the streaming fit over the ranks' shards, through the spill
    x, init = _kmeans_corpus()
    local = x[rank::world]
    feeds = [local[i : i + KM_FEED] for i in range(0, len(local), KM_FEED)]
    spill = out / f"kmeans_spill_{rank}.bin"
    history = []
    c, obj, n = kmeans_fit_streaming(
        lambda: iter(feeds), KM_K, niter=3, d=KM_D, init_centroids=init,
        superbatch_rows=1024, chunk=128, cache_mb=0, cache_spill_path=spill,
        cache_spill_mb=64, device="cpu", group=data_group(),
        checkpoint_fn=lambda it, c, o: history.append(c.numpy().copy()))
    res.update(c_centroids=c.numpy(), c_obj=np.float64(obj),
               c_n=np.int64(n), c_spill_left=spill.exists(),
               c_history=np.stack(history))
    drawn, _, _ = kmeans_fit_streaming(
        lambda: iter(feeds), KM_K, niter=3, d=KM_D, superbatch_rows=1024,
        chunk=128, device="cpu", group=data_group())
    res["c_drawn"] = drawn.numpy()
    few = [local[:KM_K - 1]] if rank == 0 else feeds  # rank 0: k - 1 rows
    try:
        kmeans_fit_streaming(lambda: iter(few), KM_K, niter=1, d=KM_D,
                             superbatch_rows=1024, chunk=128, device="cpu",
                             group=data_group())
        res["c_few_refused"] = False
    except ValueError as e:
        res["c_few_refused"] = "process 0's first super-batch" in str(e)

    # D: the tokenize and spectrogram stages, clips sharded
    stats = SpecTokenizer(cfgs["d_tok"], "cpu").run()["train"]
    res["d_tok_stats"] = np.array([stats["total_tokens"],
                                   stats["unique_tokens"]])
    SpectrogramGenerator(cfgs["d_spec"], "cpu").run()
    res["d_spec_seen"] = np.array([len(list(
        (Path(cfgs["d_spec"].dest_spec_path) / "train").glob("*.npy")))])

    # E: the pipeline in full mode on D's workspace
    try:
        ClusterCreator(cfgs["d_spec"], "cpu")  # batch_warm_start
        res["e_warm_start_refused"] = False
    except ValueError:
        res["e_warm_start_refused"] = True
    full = cfgs["e_full"]
    res["e_centroids"] = ClusterCreator(full, "cpu").run()
    SpecTokenizer(full, "cpu").run()
    res["e_n_tokens"] = np.int64(len(list(
        (Path(full.dest_tokenized_path) / "train").glob("*.npy"))))
    train("e_full", ModelTrainer(full, "cpu"))
    res["e_train_epochs"] = res.pop("e_full_epochs")
    np.savez(out / f"result_{rank}.npz", **res)
    distributed.barrier("done")
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
               Path(sys.argv[4]))
