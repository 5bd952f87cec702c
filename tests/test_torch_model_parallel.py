"""Tensor and sequence parallelism of the port's bert on four CPU ranks
(gloo, ``parallel/mesh.make_mesh``), against the JAX module in one process
and against one process of the port, on the same inputs:

  A. the model on a TP 2 x SP 2 mesh from the JAX init
     (``convert.bert_state_dict``): logits with and without lengths on the
     plain route and on B5's (its plain version, a query block against the
     gathered keys) against the unsharded JAX ``TransformerClassifier``
     (1e-5, JAX ``tests/test_sequence_parallel.py:135-156``), the loss's
     gradients, summed over the mesh's replica group and joined over the
     model ranks, against JAX's (rtol 1e-4, atol 1e-6, ``:91-133``); the
     same on B5's route in eval mode (the query block's backward: dq of
     the rank's rows, its share of dk and dv summed by the gather's
     backward), with and without lengths and under ``remat``, against
     JAX's deterministic gradients; with dropout 0.1 in training mode,
     logits and gradients against one process of the port (the same
     masks); under ``remat`` (each block
     recomputed in the backward, its collectives replayed there), without
     dropout against JAX and with dropout 0.1 against one process, each
     also against the sharded run without remat;
  B. ``ModelTrainer`` data 2 x sequence 2 on a token corpus (JAX
     ``tests/test_sequence_parallel.py:158``): every step's loss (the data
     ranks' shares summed) and the epoch's numbers within 1e-5 of one
     process;
  C. ``Trainer.run()`` on a TP 2 x SP 2 mesh with dropout and B5 in its
     validation: step losses within 1e-5 of one process, ``device_corpus
     'auto'`` streams, and the best checkpoint, written in one process's
     layout, loads into one process and gives the sharded model's
     probabilities within 1e-6, and back into a sharded ``Trainer`` as each
     rank's own slices of the weights and the AdamW moments;
  D. a batch that does not split over the data axis, refused with the JAX
     message;
  E. the gradient-flow report (``Trainer.gradient_report``) of C's model
     (plain attention) on the TP 2 x SP 2 mesh, from the JAX init of that
     model: rank 0's report, over one unsharded model of the joined
     weights, against the JAX ``gradient_flow`` on the same weights and
     first batch in one process (each statistic within rel 1e-4 / abs
     1e-9, as ``tests/test_torch_diagnostics.py``); the other ranks join
     the weights and report nothing.

The ranks run this file as a script (``tests/torch_ranks.py``):

    python tests/test_torch_model_parallel.py PORT RANK WORLD OUTDIR

reading ``OUTDIR/inputs.pt`` and ``OUTDIR/configs.json`` and writing
``OUTDIR/result_<rank>.pt``.  The JAX trainer's refusals that the port
keeps are tested in one process at the end.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 4
B, T, V, C = 4, 128, 64, 11  # the JAX test's sizes
DROPOUT_GEN_SEED = 5
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PROBS_ATOL = 1e-6


def _model_kw(**kw):
    out = dict(vocab_size=V, num_layers=2, num_classes=C, hidden_size=128,
               max_position=T, dropout=0.0)
    out.update(kw)
    return out


def _port_model(state, impl="xla", dropout=0.0, remat=False):
    from audio_tokens_tpu_torch.models.transformer import (
        TransformerClassifier)

    m = TransformerClassifier(**_model_kw(dropout=dropout), remat=remat,
                              attention_impl=impl, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    m.load_state_dict(state)
    return m


def _loss(logits, labels):
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels)


def _step(model, x, lengths, labels, gen=None):
    """(logits, {name: gradient}) of one loss + backward."""
    model.zero_grad(set_to_none=True)
    logits = model(x, lengths, generator=gen)
    _loss(logits, labels).backward()
    return logits.detach(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}


def _trainer_config(out: Path, name: str):
    """B's and C's configs (JAX dicts: the port's config takes them)."""
    from tests import token_corpus

    kw = dict(model_type="bert", num_layers=1, epochs=1,
              training_batch_size=8, transformer_max_position=64,
              compute_dtype="float32",  # bf16 rounds partial sums apart
              checkpoint_dir=str(out / f"ckpt_{name}"))
    if name == "b":
        kw.update(hidden_size=64, data_parallel=2, sequence_parallel=2,
                  dropout=0.0)
    else:
        kw.update(hidden_size=128, model_parallel=2, sequence_parallel=2,
                  dropout=0.1, transformer_attention="flash",
                  device_corpus="auto", save_best_checkpoint=True)
    if name == "e":  # E's report: C's model on the plain attention route
        kw.update(transformer_attention="xla", save_best_checkpoint=False)
    return token_corpus.config(out / "tokens", **kw)


def _recorded_run(trainer):
    """``trainer.run()`` -> (its return, every step's loss)."""
    losses = []
    step = trainer._train_step

    def recorded(*args):
        got = step(*args)
        losses.append(float(got[0]))
        return got

    trainer._train_step = recorded
    return trainer.run(), losses


def _first_batch(cfg) -> dict:
    """The first training batch of epoch 0 (the seeded loader's)."""
    from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator

    batches = DataLoaderCreator(cfg).get_dataloaders()[0].batches(0)
    try:
        return next(batches)
    finally:
        batches.close()


def _val_batch(cfg):
    """The first validation batch (inputs, lengths) as tensors."""
    from audio_tokens_tpu_torch.data.datasets import DataLoaderCreator
    from audio_tokens_tpu_torch.train.objective import model_inputs

    _, val = DataLoaderCreator(cfg).get_dataloaders()
    batch = next(iter(val.batches(0)))
    return (model_inputs(torch.from_numpy(batch["inputs"])),
            torch.from_numpy(batch["lengths"]))


# -- the ranks ------------------------------------------------------------

def _rank_main(port: str, rank: int, world: int, out: Path) -> None:
    from tests import torch_ranks

    torch_ranks.join(port, rank, world)
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.parallel.mesh import make_mesh, tp_gather
    from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer
    from audio_tokens_tpu_torch.train.trainer import Trainer, mesh_for

    inp = torch.load(out / "inputs.pt")
    x, lengths, labels = inp["tokens"], inp["lengths"], inp["labels"]
    res = {}
    # A. the model on TP 2 x SP 2
    mesh = make_mesh(data=1, model=2, seq=2)
    for impl in ("xla", "flash"):
        m = _port_model(inp["state"], impl).shard_(mesh).eval()
        with torch.no_grad():
            res[f"a_{impl}"] = m(x)
            res[f"a_{impl}_lengths"] = m(x, lengths)
    for tag, dropout in (("a_grads", 0.0), ("a_dropout", 0.1),
                         ("a_remat", 0.0), ("a_remat_dropout", 0.1)):
        m = _port_model(inp["state"], dropout=dropout,
                        remat="remat" in tag).shard_(mesh)
        m.train(dropout > 0)
        gen = torch.Generator().manual_seed(DROPOUT_GEN_SEED)
        logits, grads = _step(m, x, lengths if dropout else None, labels,
                              gen)
        for g in grads.values():
            mesh.replica.all_reduce_(g)
        res[tag] = dict(logits=logits, grads=tp_gather(mesh, grads,
                                                       m.tp_specs))
    # the B5 route's gradient in eval mode (its plain version on the CPU)
    for tag, remat, ln in (("a_flash_grads", False, None),
                           ("a_flash_grads_lengths", False, lengths),
                           ("a_flash_remat", True, None)):
        m = _port_model(inp["state"], "flash", remat=remat).shard_(mesh)
        logits, grads = _step(m.eval(), x, ln, labels)
        for g in grads.values():
            mesh.replica.all_reduce_(g)
        res[tag] = dict(logits=logits, grads=tp_gather(mesh, grads,
                                                       m.tp_specs))
    cfgs = {k: AudioTokensConfig(**v) for k, v in json.loads(
        (out / "configs.json").read_text()).items()}
    # B. ModelTrainer, data 2 x sequence 2
    (_, val_metrics), steps = _recorded_run(ModelTrainer(cfgs["b"], "cpu"))
    res["b_steps"], res["b_val_mAP"] = steps, val_metrics["mAP"]
    # C. Trainer.run() on TP 2 x SP 2, the checkpoint, the sharded eval
    trainer = Trainer(cfgs["c"], "cpu")
    res["c_streams"] = trainer._maybe_device_runner(None, None) is None
    (val_loss, _), steps = _recorded_run(trainer)
    res["c_steps"], res["c_val_loss"] = steps, val_loss
    trainer.model.eval()
    with torch.no_grad():
        res["c_probs"] = torch.sigmoid(trainer._logits(*_val_batch(
            cfgs["c"])))
    # the best checkpoint (the one epoch's end) back into a sharded Trainer
    resumed = Trainer(cfgs["c"], "cpu")
    resumed._load(f"{trainer.run_name}-best")
    res["c_resumed"] = [
        (n, torch.equal(a, b)) for (n, a), b in zip(
            trainer.model.state_dict().items(),
            resumed.model.state_dict().values())] + [
        (f"{i} {k}", torch.equal(v, resumed.optimizer.state[q][k]))
        for i, (p, q) in enumerate(zip(trainer.model.parameters(),
                                       resumed.model.parameters()))
        for k, v in trainer.optimizer.state[p].items()]
    # D. a batch that does not split over the data axis
    try:
        mesh_for(cfgs["d"])
    except ValueError as e:
        res["d_refused"] = str(e)
    # E. the gradient-flow report on TP 2 x SP 2, from the JAX init
    reporter = Trainer(cfgs["e"], "cpu")
    reporter._load_params(torch.load(out / "report_state.pt"))
    res["e_report"] = reporter.gradient_report(_first_batch(cfgs["e"]))
    torch.save(res, out / f"result_{rank}.pt")


# -- the references, in this process -------------------------------------------

def _jax_model():
    from audio_tokens_tpu.models.transformer import TransformerClassifier

    return TransformerClassifier(**_model_kw())


def _jax_inputs(out: Path) -> dict:
    """The inputs and the JAX module's init, which the ranks take
    (``inputs.pt``)."""
    import jax
    import jax.numpy as jnp

    from audio_tokens_tpu_torch.convert import bert_state_dict

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, V, size=(B, T)).astype(np.int32)
    labels = rng.integers(0, 2, size=(B, C)).astype(np.float32)
    lengths = np.asarray([T, 100, 64, 17], np.int32)
    params = jax.jit(_jax_model().init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(tokens))["params"]
    torch.save(dict(tokens=torch.from_numpy(tokens).long(),
                    lengths=torch.from_numpy(lengths),
                    labels=torch.from_numpy(labels),
                    state=bert_state_dict(jax.device_get(params))),
               out / "inputs.pt")
    return dict(params=params, tokens=tokens, labels=labels, lengths=lengths)


def _jax_references(inputs: dict) -> dict:
    """The JAX module's logits and the loss's gradients, with and without
    lengths, unsharded."""
    import jax
    import jax.numpy as jnp
    import optax

    from audio_tokens_tpu_torch.convert import bert_state_dict

    model = _jax_model()
    params, x = inputs["params"], jnp.asarray(inputs["tokens"])

    @jax.jit
    def loss_fn(p, y, ln):
        logits = model.apply({"params": p}, x, lengths=ln, deterministic=True)
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    apply = jax.jit(lambda ln: model.apply({"params": params}, x, lengths=ln,
                                           deterministic=True))
    grad = jax.jit(jax.grad(loss_fn))
    y, ln = jnp.asarray(inputs["labels"]), jnp.asarray(inputs["lengths"])
    return dict(logits=np.asarray(apply(None)),
                logits_lengths=np.asarray(apply(ln)),
                grads=bert_state_dict(jax.device_get(grad(params, y, None))),
                grads_lengths=bert_state_dict(jax.device_get(
                    grad(params, y, ln))))


def _jax_report_inputs(out: Path, cfg) -> dict:
    """E's JAX model, its init on the first training batch (carried into
    ``report_state.pt`` for the ranks) and that batch."""
    import jax

    from audio_tokens_tpu.data.datasets import DataLoaderCreator as Loaders
    from audio_tokens_tpu.models import get_model as jax_model
    from audio_tokens_tpu.utils.seeding import key_for
    from audio_tokens_tpu_torch.convert import state_dict_for

    batch = next(iter(Loaders(cfg).get_dataloaders()[0].batches(0)))
    model = jax_model(cfg)
    params = model.init(key_for(0, "model_init"), batch["inputs"],
                        lengths=batch["lengths"])["params"]
    torch.save(state_dict_for("bert", jax.device_get(params)),
               out / "report_state.pt")
    return dict(model=model, params=params, batch=batch)


def _jax_report(cfg, inputs: dict) -> dict:
    """The JAX ``gradient_flow`` of E's weights on its batch, keyed by the
    port's parameter names."""
    from audio_tokens_tpu.utils import diagnostics
    from tests.test_torch_diagnostics import _port_names

    report = diagnostics.gradient_flow(diagnostics.make_batch_loss(
        inputs["model"], inputs["batch"], not cfg.reference_compat),
        inputs["params"])
    names = _port_names("bert", inputs["params"])
    return {names[k]: v for k, v in report.items()}


def _port_references(out: Path, cfgs: dict) -> dict:
    """One process of the port: the dropout step, B's and C's runs."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer

    inp = torch.load(out / "inputs.pt")
    m = _port_model(inp["state"], dropout=0.1).train()
    logits, grads = _step(m, inp["tokens"], inp["lengths"], inp["labels"],
                          torch.Generator().manual_seed(DROPOUT_GEN_SEED))
    refs = dict(a_dropout=dict(logits=logits, grads=grads))
    for name in ("b", "c"):
        one = AudioTokensConfig(**{
            **cfgs[name].to_dict(), "data_parallel": -1, "model_parallel": 1,
            "sequence_parallel": 1,
            "checkpoint_dir": str(out / f"one_ckpt_{name}")})
        (val_loss, val_metrics), steps = _recorded_run(
            ModelTrainer(one, "cpu"))
        refs[name] = dict(steps=steps, val_loss=val_loss,
                          val_mAP=val_metrics["mAP"])
    return refs


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    from tests import token_corpus, torch_ranks

    out = tmp_path_factory.mktemp("torch_tp_sp")
    t0 = time.perf_counter()
    inputs = _jax_inputs(out)
    token_corpus.make_token_corpus(out / "tokens")
    cfgs = {name: _trainer_config(out, name) for name in ("b", "c", "e")}
    report_inputs = _jax_report_inputs(out, cfgs["e"])
    cfgs["d"] = token_corpus.config(
        out / "tokens", model_type="bert", hidden_size=64, num_layers=1,
        transformer_max_position=64, data_parallel=2, sequence_parallel=2,
        training_batch_size=5)
    (out / "configs.json").write_text(json.dumps(
        {k: v.to_dict() for k, v in cfgs.items()}))
    procs = torch_ranks.start(Path(__file__).resolve(), WORLD, out)
    try:
        jax_refs = _jax_references(inputs)
        jax_refs["report"] = _jax_report(cfgs["e"], report_inputs)
        refs = _port_references(out, cfgs)
    finally:
        torch_ranks.finish(procs, out)
    got = [torch.load(out / f"result_{r}.pt") for r in range(WORLD)]
    print(f"four-rank module: {time.perf_counter() - t0:.1f} s")
    return dict(got=got, jax=jax_refs, refs=refs, out=out, cfgs=cfgs)


def _close(got, want, what, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


# -- A --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_tp_sp_logits_match_the_jax_module(mp, impl, with_lengths):
    key = f"a_{impl}" + ("_lengths" if with_lengths else "")
    want = mp["jax"]["logits_lengths" if with_lengths else "logits"]
    for r, got in enumerate(mp["got"]):
        _close(got[key], want, f"rank {r} {key}", LOGIT_TOL)


def test_tp_sp_gradients_match_the_jax_module(mp):
    want = mp["jax"]["grads"]
    for r, got in enumerate(mp["got"]):
        grads = got["a_grads"]["grads"]
        assert set(grads) == set(want)
        for name, g in grads.items():
            _close(g, want[name], f"rank {r} {name}", GRAD_TOL)


@pytest.mark.parametrize("case", ["a_flash_grads", "a_flash_grads_lengths",
                                  "a_flash_remat"])
def test_tp_sp_flash_route_gradients_match_the_jax_module(mp, case):
    """Eval mode on B5's route: each sequence rank's query block against
    the gathered keys, B5's backward on that block (dq of its rows, its
    share of dk and dv, summed over the sequence ranks by the gather's
    backward); with lengths, and each block recomputed under ``remat``.
    Logits and the joined gradients against JAX's deterministic ones."""
    lengths = case.endswith("lengths")
    want = mp["jax"]["grads_lengths" if lengths else "grads"]
    want_logits = mp["jax"]["logits_lengths" if lengths else "logits"]
    for r, got in enumerate(mp["got"]):
        _close(got[case]["logits"], want_logits, f"rank {r} logits",
               LOGIT_TOL)
        grads = got[case]["grads"]
        assert set(grads) == set(want)
        for name, g in grads.items():
            _close(g, want[name], f"rank {r} {name}", GRAD_TOL)


def test_tp_sp_dropout_step_is_one_process(mp):
    """Dropout 0.1 in training mode: the ranks draw the whole window's
    masks and keep their rows, so logits and gradients are one process's."""
    want = mp["refs"]["a_dropout"]
    for r, got in enumerate(mp["got"]):
        _close(got["a_dropout"]["logits"], want["logits"], f"rank {r}",
               LOGIT_TOL)
        for name, g in got["a_dropout"]["grads"].items():
            _close(g, want["grads"][name], f"rank {r} {name}", GRAD_TOL)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["plain", "dropout"])
def test_tp_sp_remat_step_is_the_step_without_remat(mp, dropout):
    """Each block recomputed in the backward (``remat``), its collectives
    and its dropout draws replayed there: logits and gradients against the
    sharded step without remat and against the unsharded reference (JAX's
    module without dropout, one process of the port with it)."""
    if dropout:
        key, ref = "a_remat_dropout", mp["refs"]["a_dropout"]
    else:
        key, ref = "a_remat", dict(logits=mp["jax"]["logits"],
                                   grads=mp["jax"]["grads"])
    for r, got in enumerate(mp["got"]):
        plain = got["a_dropout" if dropout else "a_grads"]
        for what, want in (("without remat", plain), ("unsharded", ref)):
            _close(got[key]["logits"], want["logits"],
                   f"rank {r} logits {what}", LOGIT_TOL)
            assert set(got[key]["grads"]) == set(want["grads"])
            for name, g in got[key]["grads"].items():
                _close(g, want["grads"][name], f"rank {r} {name} {what}",
                       GRAD_TOL)


# -- B, C, D ------------------------------------------------------------------

def _data_steps(got: list, key: str, data: int) -> np.ndarray:
    """Every step's loss: the shares of the ranks of sequence and model
    place 0 summed over the data places (rank d * WORLD / data)."""
    per = WORLD // data
    return np.sum([got[d * per][key] for d in range(data)], axis=0)


def test_dp_sp_model_trainer_steps_are_one_process(mp):
    got, ref = mp["got"], mp["refs"]["b"]
    steps = _data_steps(got, "b_steps", 2)
    assert len(steps) == len(ref["steps"]) == 3  # 18 clips, batch 8
    _close(steps, ref["steps"], "B step losses", LOSS_TOL)
    for g in got:
        assert g["b_val_mAP"] == pytest.approx(ref["val_mAP"], abs=1e-5)


def test_tp_sp_trainer_steps_are_one_process(mp):
    got, ref = mp["got"], mp["refs"]["c"]
    assert all(g["c_streams"] for g in got)
    for g in got:  # data 1: every rank's share is the whole loss
        _close(g["c_steps"], ref["steps"], "C step losses", LOSS_TOL)
        _close(g["c_val_loss"], ref["val_loss"], "C val loss", LOSS_TOL)


def test_tp_sp_checkpoint_serves_in_one_process(mp):
    """The checkpoint rank 0 wrote holds one process's layout: it loads
    into one process's model, whose probabilities are the sharded
    model's."""
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.models import get_model
    from audio_tokens_tpu_torch.train import checkpoint as ckpt

    cfg = AudioTokensConfig(**mp["cfgs"]["c"].to_dict())
    model = get_model(cfg, torch.device("cpu"), torch.Generator())
    ckpt.load_params(cfg.checkpoint_dir, "no-wandb-best", model)
    model.eval()
    x, lengths = _val_batch(cfg)
    with torch.no_grad():
        probs = torch.sigmoid(model(
            x, None if cfg.reference_compat else lengths))
    for r, got in enumerate(mp["got"]):
        _close(got["c_probs"], probs, f"rank {r}",
               dict(rtol=0, atol=PROBS_ATOL))


def test_tp_sp_checkpoint_resumes_each_ranks_slices(mp):
    """The checkpoint in one process's layout, loaded by a sharded
    ``Trainer``: every rank's weights and AdamW moments (its slices of the
    split ones) are those its run ended with, bit for bit."""
    for r, got in enumerate(mp["got"]):
        assert len(got["c_resumed"]) > 3 * 2 * 6  # weights + 3 states a param
        assert [n for n, same in got["c_resumed"] if not same] == [], r


def test_batch_not_divisible_by_the_data_axis_refused(mp):
    for got in mp["got"]:
        assert got["d_refused"] == (
            "batch sizes (5 train / 5 eval) must be divisible by the data "
            "axis (2) when model_parallel=1 / sequence_parallel=2 is "
            "requested")


def test_tp_sp_gradient_report_matches_jax(mp):
    """E: rank 0's report over the joined weights is the JAX report of
    those weights on that batch; the other ranks report nothing."""
    want = mp["jax"]["report"]
    got = mp["got"][0]["e_report"]
    assert sorted(got) == sorted(want)
    for name, stats in want.items():
        for key in ("mean_abs_grad", "max_abs_grad"):
            assert got[name][key] == pytest.approx(
                stats[key], rel=1e-4, abs=1e-9), (name, key)
    assert all(g["e_report"] is None for g in mp["got"][1:])


# -- the JAX trainer's refusals, in one process --------------------------------

@pytest.mark.parametrize("override,match", [
    (dict(model_type="simple", sequence_parallel=2), "sequence_parallel"),
    (dict(model_type="bert", sequence_parallel=3,
          transformer_max_position=128), "divisible"),
    (dict(model_type="simple", model_parallel=2), "only meaningful"),
], ids=["sp-needs-bert", "sp-window-divisible", "tp-needs-bert"])
def test_jax_refusals_kept(mp, override, match):
    """Each of the JAX trainer's checks that the port keeps raises in
    both, with one message (the JAX trainer raises the last when it
    places the weights)."""
    from audio_tokens_tpu.data.datasets import (
        DataLoaderCreator as JaxLoaders)
    from audio_tokens_tpu.processors.model_trainer import (
        ModelTrainer as JaxModelTrainer)
    from audio_tokens_tpu_torch.config import AudioTokensConfig
    from audio_tokens_tpu_torch.processors.model_trainer import ModelTrainer
    from tests import token_corpus

    jcfg = token_corpus.config(mp["out"] / "tokens", **override)
    with pytest.raises(ValueError, match=match) as jax_err:
        t = JaxModelTrainer(jcfg)
        t._init_state(JaxLoaders(jcfg).get_dataloaders()[0])
    with pytest.raises(ValueError, match=match) as port_err:
        ModelTrainer(AudioTokensConfig(**jcfg.to_dict()), "cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_device_corpus_on_refused_with_tp_or_sp(tmp_path):
    from audio_tokens_tpu_torch.train.trainer import check_options
    from tests import token_corpus

    cfg = token_corpus.port_config(tmp_path, model_type="bert",
                                   sequence_parallel=2, device_corpus="on",
                                   transformer_max_position=64)
    with pytest.raises(ValueError, match="device_corpus='on' is "
                       "incompatible with model_parallel"):
        check_options(cfg)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
               Path(sys.argv[4]))
