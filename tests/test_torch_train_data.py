"""The port's copies of the framework-free training modules equal the JAX
package's originals: metadata, split files, ``BatchLoader`` batches and
their order, the mAP metrics, the bounded producer, atomic artifact writes,
and the seeding of explicit generators."""

import jax
import numpy as np
import pytest
import torch

from audio_tokens_tpu.data import datasets as jax_datasets
from audio_tokens_tpu.data import metadata as jax_metadata
from audio_tokens_tpu.data import splitter as jax_splitter
from audio_tokens_tpu.utils import metrics as jax_metrics
from audio_tokens_tpu.utils import npy_io as jax_npy_io
from audio_tokens_tpu.utils import worker as jax_worker
from audio_tokens_tpu.utils.seeding import key_for
from audio_tokens_tpu_torch.data import datasets as port_datasets
from audio_tokens_tpu_torch.data import metadata as port_metadata
from audio_tokens_tpu_torch.data import splitter as port_splitter
from audio_tokens_tpu_torch.utils import metrics as port_metrics
from audio_tokens_tpu_torch.utils import npy_io as port_npy_io
from audio_tokens_tpu_torch.utils import worker as port_worker
from audio_tokens_tpu_torch.utils.seeding import (generator_for, stage_hash,
                                                  stage_seed)
from tests import token_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("token_corpus")
    token_corpus.make_token_corpus(base)
    return base


def test_metadata_equals_original(corpus):
    jcfg = token_corpus.config(corpus)
    pcfg = token_corpus.port_config(corpus)
    j = jax_metadata.AudiosetMetadataProcessor(jcfg)
    p = port_metadata.AudiosetMetadataProcessor(pcfg)
    assert p.label_index == j.label_index
    assert p.ytid_labels == j.ytid_labels
    for ytid in j.get_all_ytids():
        np.testing.assert_array_equal(p.multi_hot(ytid, 7),
                                      j.multi_hot(ytid, 7))
    assert (port_metadata.load_class_names(pcfg)
            == jax_metadata.load_class_names(jcfg))


@pytest.mark.parametrize("ratio,seed", [(1.0, 4242), (0.5, 7)])
def test_split_file_equals_original(corpus, tmp_path, ratio, seed):
    kw = dict(dataset_ratio=ratio, random_seed=seed)
    jcfg = token_corpus.config(corpus, split_file=str(tmp_path / "j.json"),
                               **kw)
    pcfg = token_corpus.port_config(
        corpus, split_file=str(tmp_path / "p.json"), **kw)
    jax_splitter.DatasetSplitter(jcfg).create_split_file(
        jax_metadata.AudiosetMetadataProcessor(jcfg))
    port_splitter.DatasetSplitter(pcfg).create_split_file(
        port_metadata.AudiosetMetadataProcessor(pcfg))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


@pytest.mark.parametrize("token_cache", [False, True])
@pytest.mark.parametrize("num_workers", [1, 3])
def test_batch_loader_batches_equal_original(corpus, tmp_path, token_cache,
                                             num_workers):
    """Byte-equal batches in the same order, both splits, two epochs.  With
    ``token_cache`` the port builds the packed cache in a fresh copy of the
    token directory and the JAX loader then validates and reads it."""
    kw = dict(token_cache=token_cache, num_workers=num_workers)
    if token_cache:
        import shutil

        shutil.copytree(corpus / "tokenized_audio", tmp_path / "tok")
        kw["dest_tokenized_path"] = str(tmp_path / "tok")
    pcfg = token_corpus.port_config(corpus, **kw)
    p_train, p_val = port_datasets.DataLoaderCreator(pcfg).get_dataloaders()
    jcfg = token_corpus.config(corpus, **kw)
    j_train, j_val = jax_datasets.DataLoaderCreator(jcfg).get_dataloaders()
    if token_cache:
        assert p_train.ds._cache is not None and j_train.ds._cache is not None
        assert (tmp_path / "tok" / "train.tokenscache.bin").exists()
    for pl, jl in ((p_train, j_train), (p_val, j_val)):
        assert len(pl) == len(jl) and pl.ds.ytids == jl.ds.ytids
        for epoch in (0, 1):
            pb, jb = list(pl.batches(epoch)), list(jl.batches(epoch))
            assert len(pb) == len(jb) == len(jl)
            for p, j in zip(pb, jb):
                assert p.keys() == j.keys() and p["n_valid"] == j["n_valid"]
                for key in ("inputs", "lengths", "labels"):
                    assert p[key].dtype == j[key].dtype
                    assert p[key].tobytes() == j[key].tobytes(), key
    assert jb[-1]["n_valid"] < jcfg.training_batch_size  # a partial batch


def test_metrics_equal_original(rng):
    labels = (rng.random((60, 9)) < 0.2).astype(np.float32)
    labels[:, 3] = 0.0  # a class without positives is skipped
    scores = rng.random((60, 9)).astype(np.float32)
    scores[10:20, 1] = 0.5  # tied scores
    for i in (0, 1, 4):
        assert (port_metrics.binary_average_precision(labels[:, i],
                                                      scores[:, i])
                == jax_metrics.binary_average_precision(labels[:, i],
                                                        scores[:, i]))
    assert (port_metrics.macro_mean_average_precision(labels, scores)
            == jax_metrics.macro_mean_average_precision(labels, scores))
    for p_acc, j_acc in ((port_metrics.StreamingMAP(9, bins=64),
                          jax_metrics.StreamingMAP(9, bins=64)),
                         (port_metrics.ExactMAP(), jax_metrics.ExactMAP())):
        for lo in range(0, 60, 25):
            p_acc.update(labels[lo:lo + 25], scores[lo:lo + 25])
            j_acc.update(labels[lo:lo + 25], scores[lo:lo + 25])
        assert p_acc.result() == j_acc.result()
    assert (port_metrics.MetricsCalculator().compute_metrics([], [])
            == jax_metrics.MetricsCalculator().compute_metrics([], []))


def test_bounded_producer_equals_original():
    def items():
        yield from range(5)
        raise KeyError("producer failed")

    for mod in (port_worker, jax_worker):
        got = []
        with pytest.raises(KeyError, match="producer failed"):
            for x in mod.BoundedProducer(items(), depth=2):
                got.append(x)
        assert got == list(range(5))
        prod = mod.BoundedProducer(iter(range(100)), depth=2)
        assert next(iter(prod)) == 0
        prod.close()
        assert not prod._thread.is_alive()


def test_atomic_save_equals_original(tmp_path, rng):
    arr = rng.integers(0, 500, (3, 40))
    port_npy_io.atomic_save_npy(tmp_path / "p.npy", arr)
    jax_npy_io.atomic_save_npy(tmp_path / "j.npy", arr)
    assert (tmp_path / "p.npy").read_bytes() == \
        (tmp_path / "j.npy").read_bytes()
    port_npy_io.atomic_save_bytes(tmp_path / "p.bin", b"abc")
    assert (tmp_path / "p.bin").read_bytes() == b"abc"
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "j.npy", "p.bin", "p.npy"]


@pytest.mark.parametrize("stage", ["trainer", "model_init", "dropout", ""])
def test_stage_hash_is_the_jax_key_for_hash(stage):
    """key_for(seed, stage) folds exactly stage_hash(stage) into the root."""
    ref = jax.random.key_data(key_for(4242, stage))
    got = jax.random.key_data(jax.random.fold_in(jax.random.key(4242),
                                                 stage_hash(stage)))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_generator_for_is_reproducible_and_per_stage():
    def draw(seed, stage):
        return torch.rand(8, generator=generator_for(seed, stage))

    assert torch.equal(draw(4242, "model_init"), draw(4242, "model_init"))
    assert not torch.equal(draw(4242, "model_init"), draw(4242, "dropout"))
    assert not torch.equal(draw(4242, "model_init"), draw(7, "model_init"))
    assert stage_seed(1, "a") != stage_seed(2, "a")
    assert 0 <= stage_seed(-1, "dropout") < 2**32
