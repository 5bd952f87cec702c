"""The port's process layer (``audio_tokens_tpu_torch/parallel``) in one
process: its arithmetic against the JAX package's (``process_shard``,
``local_row_bounds``, ``data_mesh``'s clamp), the topology it reads from
the config and the environment, the refusals that stay (A7.5), and the
entry points that once refused multi-process options (``data_parallel``,
``distributed=True``) running in a world of one rank, equal to a plain
run.  Two ranks are held to the JAX package in
``tests/test_torch_multiprocess.py``."""

import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_tokens_tpu.parallel import distributed as jax_dist
from audio_tokens_tpu.parallel.mesh import data_mesh
from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.parallel import distributed, mesh
from audio_tokens_tpu_torch.processors import SpectrogramGenerator
from audio_tokens_tpu_torch.train.trainer import Trainer
from tests import fixtures, token_corpus

LAUNCH_VARS = ("AUDIO_TOKENS_COORDINATOR", "AUDIO_TOKENS_NUM_PROCESSES",
               "AUDIO_TOKENS_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
               "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    return monkeypatch


@pytest.fixture
def torchrun_of_one(no_launcher):
    """torchrun's variables for a world of one rank; the group the code
    under test makes from them is destroyed after the test."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port))):
        no_launcher.setenv(k, v)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("n,index,count", [
    (9, 0, 2), (9, 1, 2), (8, 3, 4), (3, 2, 4), (0, 0, 2), (5, 0, 1)])
def test_process_shard_is_the_jax_shard(n, index, count):
    items = [f"clip{i}" for i in range(n)]
    got = distributed.process_shard(items, index, count)
    assert got == jax_dist.process_shard(items, index, count)
    # the shards partition the list
    every = [distributed.process_shard(items, i, count)
             for i in range(count)]
    assert sorted(sum(every, [])) == sorted(items)


@pytest.mark.parametrize("n_rows,index,count", [
    (64, 0, 2), (64, 1, 2), (8, 3, 4), (4, 0, 1), (12, 2, 3)])
def test_local_row_bounds_are_the_jax_bounds(n_rows, index, count):
    assert (distributed.local_row_bounds(n_rows, index, count)
            == jax_dist.local_row_bounds(n_rows, index, count))


def test_local_row_bounds_refuse_an_uneven_split():
    for fn in (distributed.local_row_bounds, jax_dist.local_row_bounds):
        with pytest.raises(ValueError, match="not divisible"):
            fn(10, 0, 4)


@pytest.mark.parametrize("world,want", [
    (1, -1), (2, -1), (4, -1), (2, 1), (4, 1), (2, 2), (2, 8), (4, 4)])
def test_data_parallel_clamp_is_data_mesh_s(world, want):
    """``data_parallel`` -> group size as the JAX ``data_mesh`` sizes its
    axis over as many devices (None there is 1 here)."""
    import jax

    cfg = AudioTokensConfig(data_parallel=want)
    ref = data_mesh(cfg, devices=jax.devices()[:world])
    assert mesh.data_parallel_size(cfg, world) == (
        1 if ref is None else ref.shape["data"])


def test_data_parallel_below_the_world_refused():
    with pytest.raises(ValueError, match="spans every rank"):
        mesh.data_parallel_size(AudioTokensConfig(data_parallel=2), 4)


def test_unconfigured_initialize_makes_no_group(no_launcher):
    assert distributed.maybe_initialize(AudioTokensConfig()) is False
    assert distributed.maybe_initialize(None) is False
    assert not dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (
        0, 1)
    assert distributed.is_coordinator() and not distributed.is_multiprocess()
    assert mesh.data_group(AudioTokensConfig()) is None
    distributed.barrier("alone")  # no-op
    np.testing.assert_array_equal(
        distributed.all_sum_hosts(np.arange(3)), np.arange(3))


def test_distributed_without_a_topology_refused(no_launcher):
    with pytest.raises(ValueError, match="torchrun or set the AUDIO_TOKENS"):
        distributed.maybe_initialize(AudioTokensConfig(distributed=True))
    assert not dist.is_initialized()


@pytest.mark.parametrize("source", ["config", "audio_tokens", "torchrun"])
def test_topology_sources(no_launcher, source):
    """The config fields, the JAX package's variables, torchrun's."""
    cfg = AudioTokensConfig(distributed=True)
    if source == "config":
        cfg = AudioTokensConfig(coordinator_address="host:123",
                                num_processes=4, process_id=3)
    elif source == "audio_tokens":
        for k, v in (("AUDIO_TOKENS_COORDINATOR", "host:123"),
                     ("AUDIO_TOKENS_NUM_PROCESSES", "4"),
                     ("AUDIO_TOKENS_PROCESS_ID", "3")):
            no_launcher.setenv(k, v)
    else:
        for k, v in (("MASTER_ADDR", "host"), ("MASTER_PORT", "123"),
                     ("WORLD_SIZE", "4"), ("RANK", "3")):
            no_launcher.setenv(k, v)
    assert distributed._topology(cfg) == ("host:123", 4, 3)


def test_backend_without_a_card_is_gloo(no_launcher):
    assert not torch.cuda.is_available()
    for n in (1, 2):
        table = [("host", 0)] * n
        assert distributed.plan_topology(table, n - 1)[0] == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()


def _hosts(*groups):
    """Rank-ordered (host, cards) table: ``groups`` of (host, cards, ranks
    on it), ranks numbered host after host."""
    return [(h, c) for h, c, n in groups for _ in range(n)]


@pytest.mark.parametrize("table, backend, local", [
    # 2 hosts x 4 cards, 8 processes launched by the AUDIO_TOKENS_*
    # variables (no LOCAL_WORLD_SIZE): every rank owns a card
    (_hosts(("a", 4, 4), ("b", 4, 4)), "nccl", [0, 1, 2, 3, 0, 1, 2, 3]),
    # the same hosts with the ranks interleaved across them
    ([("a", 4), ("b", 4)] * 4, "nccl", [0, 0, 1, 1, 2, 2, 3, 3]),
    # 8 processes on one host of 4 cards: ranks share cards
    (_hosts(("a", 4, 8)), "gloo", list(range(8))),
    # one host short of cards makes every rank take gloo
    (_hosts(("a", 4, 4), ("b", 2, 4)), "gloo", [0, 1, 2, 3, 0, 1, 2, 3]),
    # two ranks sharing one card, and one rank on it alone
    (_hosts(("a", 1, 2)), "gloo", [0, 1]),
    (_hosts(("a", 1, 1)), "nccl", [0]),
], ids=["2x4-8proc", "2x4-interleaved", "1x4-8proc", "uneven-hosts",
        "2-on-1-card", "1-on-1-card"])
def test_plan_topology(table, backend, local):
    """Every rank reads the same table of hosts and cards, so all pick the
    same backend; each takes its place among its host's ranks."""
    plans = [distributed.plan_topology(table, r) for r in range(len(table))]
    assert [b for b, _ in plans] == [backend] * len(table)
    assert [i for _, i in plans] == local


def test_plan_topology_takes_torchrun_local_rank():
    assert distributed.plan_topology([("a", 2)] * 2, 0, local_rank=1) == (
        "nccl", 1)


def test_tensor_parallel_helpers_refused():
    """``tp_param_specs`` splits the parameters the JAX ``TP_RULES`` split
    (the port's in whole heads, on (out, in) weights), and
    ``tp_shardings`` / ``tp_gather``'s slices join into the whole."""
    import jax
    import jax.numpy as jnp

    from audio_tokens_tpu.models.transformer import (
        TP_RULES as JAX_RULES, TransformerClassifier as JaxBert)
    from audio_tokens_tpu.parallel.mesh import (
        tp_param_specs as jax_tp_param_specs)
    from audio_tokens_tpu_torch.convert import bert_state_dict
    from audio_tokens_tpu_torch.models.transformer import (
        TransformerClassifier)

    jmodel = JaxBert(vocab_size=16, num_layers=1, num_classes=3,
                     hidden_size=128, max_position=8)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    jspecs = jax_tp_param_specs(params, JAX_RULES)
    leaves, tree = jax.tree_util.tree_flatten(params)
    spec_leaves = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    split = jax.tree_util.tree_unflatten(tree, [
        np.full(p.shape, float("model" in tuple(sp)))
        for p, sp in zip(leaves, spec_leaves)])
    jax_split = {k for k, v in bert_state_dict(split).items()
                 if v.reshape(-1)[0] == 1.0}
    model = TransformerClassifier(16, 1, 3, hidden_size=128, max_position=8,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    specs = mesh.tp_param_specs(model)
    assert {k for k, d in specs.items() if d is not None} == jax_split
    full = dict(model.named_parameters())
    for name, dim in specs.items():
        if dim is not None:  # out-features of column layers, in of rows
            assert dim == (1 if "out.weight" in name else 0), name
    pieces = []
    for r in range(2):  # each rank of a model axis of 2, in turn
        two = mesh.make_mesh()
        two = mesh.Mesh(two.data, two.sequence, mesh.DataGroup(), two.replica)
        two.model.size, two.model.rank = 2, r
        pieces.append(mesh.tp_shardings(two, model))
    for name, dim in specs.items():
        joined = (full[name] if dim is None
                  else torch.cat([p[name] for p in pieces], dim))
        torch.testing.assert_close(joined, full[name], rtol=0, atol=0)
        if dim is not None:  # whole heads: query rows [r 64, (r + 1) 64)
            assert pieces[1][name].shape[dim] == full[name].shape[dim] // 2


# -- the options that once refused, in a world of one ----------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_tokens")
    token_corpus.make_token_corpus(base)
    return base


def _train(corpus, ckpt: Path, **kw):
    cfg = token_corpus.port_config(corpus, model_type="simple", epochs=1,
                                   max_train_steps=3,
                                   checkpoint_dir=str(ckpt), **kw)
    t = Trainer(cfg, "cpu")
    val = t.run()
    return t, val, {k: v.clone() for k, v in t.model.state_dict().items()}


def _assert_same_run(a, b):
    assert a[1] == b[1]
    for k in a[2]:
        torch.testing.assert_close(b[2][k], a[2][k], atol=0, rtol=0, msg=k)


def test_data_parallel_in_one_process_trains_as_one(no_launcher, corpus,
                                                    tmp_path):
    """``data_parallel=2`` in one process (no group): clamped to 1, the
    same run as the default."""
    plain = _train(corpus, tmp_path / "a")
    asked = _train(corpus, tmp_path / "b", data_parallel=2)
    assert asked[0].dp is None
    _assert_same_run(plain, asked)


def test_distributed_trainer_in_a_world_of_one(torchrun_of_one, corpus,
                                               tmp_path):
    """``distributed=True`` under torchrun's variables: the group is made
    (gloo, no card), and one rank trains as one process."""
    run = _train(corpus, tmp_path / "a", distributed=True)
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert distributed.backend() == "gloo" and run[0].dp is None
    dist.destroy_process_group()
    plain = _train(corpus, tmp_path / "b")
    _assert_same_run(plain, run)
    # rank 0 is the coordinator: it wrote the history
    assert (tmp_path / "a" / "no-wandb-metrics.jsonl").exists()


def test_distributed_spectrogram_stage_in_a_world_of_one(torchrun_of_one,
                                                         tmp_path):
    """The spectrogram stage under ``distributed=True`` (a world of one):
    every clip, the files of a plain run."""
    from audio_tokens_tpu.data.metadata import AudiosetMetadataProcessor
    from audio_tokens_tpu.data.splitter import DatasetSplitter

    out = {}
    for name, kw in (("plain", {}), ("dist", {"distributed": True})):
        ws = tmp_path / name
        fixtures.make_workspace(ws, n_clips=4)
        jcfg = fixtures.test_config(ws, dataset_ratio=1.0)
        DatasetSplitter(jcfg).create_split_file(
            AudiosetMetadataProcessor(jcfg))
        cfg = AudioTokensConfig(**{**jcfg.to_dict(), **kw,
                                   "audio_backend": "python"})
        SpectrogramGenerator(cfg, "cpu").run()
        out[name] = {f.relative_to(ws): np.load(f) for f in sorted(
            (ws / "spectrograms").rglob("*.npy"))}
    assert dist.is_initialized()
    assert sorted(out["dist"]) == sorted(out["plain"]) and out["plain"]
    for k, v in out["plain"].items():
        np.testing.assert_array_equal(out["dist"][k], v, err_msg=str(k))
