"""The port's Trainer on the bert classifier against the JAX Trainer, on the
tokenized fixture corpus of ``tests/token_corpus.py``, under a weight
transplant: hidden 64 (one head of 64), 1 layer, f32 compute,
``transformer_attention="flash"``.  Training steps take the plain attention
route in both packages; initialization (JAX) and validation run the flash
route, JAX's through the library Pallas kernel in interpret mode.
Per-step losses within 5e-5, val loss within 5e-5 and val mAP within 1e-3,
as ``tests/test_torch_train.py`` holds the lstm."""

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from audio_tokens_tpu.data.datasets import DataLoaderCreator
from audio_tokens_tpu.train import trainer as jax_trainer
from audio_tokens_tpu_torch.convert import bert_state_dict
from audio_tokens_tpu_torch.models.transformer import TransformerClassifier
from audio_tokens_tpu_torch.train import trainer as port_trainer
from tests import token_corpus

LOSS_ATOL = 5e-5
MAP_ATOL = 1e-3
BERT = dict(model_type="bert", transformer_attention="flash",
            compute_dtype="float32", hidden_size=64, num_layers=1, epochs=1)


def interpret():
    """Run Pallas kernels by the generic interpreter (``pallas_call(...,
    interpret=True)``, as the JAX package's own kernel tests run them): the
    kernel becomes plain JAX ops.  TPU interpret mode (the default params)
    runs the kernel through host callbacks, and an op dispatched while those
    run can deadlock the CPU device queue."""
    return pltpu.force_tpu_interpret_mode(True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("token_corpus")
    token_corpus.make_token_corpus(base)
    return base


def _record_losses(monkeypatch, module):
    seen = []
    add = module._LossMean.add

    def recording_add(self, loss):
        seen.append(float(np.asarray(loss)))
        add(self, loss)

    monkeypatch.setattr(module._LossMean, "add", recording_add)
    return seen


@pytest.mark.parametrize("reference_compat", [True, False])
def test_bert_trainer_matches_jax_trainer(corpus, tmp_path, monkeypatch,
                                          reference_compat):
    """With ``reference_compat=False`` the lengths reach attention, and the
    padded rows of a final partial batch (weight 0) have length 0: their
    logits differ between the two routes' segment handling but must stay
    finite, so the weighted loss is unchanged."""
    kw = dict(BERT, reference_compat=reference_compat,
              checkpoint_dir=str(tmp_path / "ckpt"))
    jcfg = token_corpus.config(corpus, **kw)
    with interpret():
        jt = jax_trainer.Trainer(jcfg)
        train_loader, _ = DataLoaderCreator(jcfg).get_dataloaders()
        params, _ = jt._init_state(train_loader)
        pt = port_trainer.Trainer(token_corpus.port_config(corpus, **kw),
                                  "cpu")
        assert isinstance(pt.model, TransformerClassifier)
        assert pt.model.attention_impl == "flash"
        pt.model.load_state_dict(bert_state_dict(jax.device_get(params)))
        jax_losses = _record_losses(monkeypatch, jax_trainer)
        j_loss, j_metrics = jt.run()
    port_losses = _record_losses(monkeypatch, port_trainer)
    p_loss, p_metrics = pt.run()

    # 5 train steps (the last on 2 real rows) + 2 eval batches
    assert len(port_losses) == len(jax_losses) == 7
    assert np.isfinite(port_losses).all()
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL,
                               rtol=0)
    assert abs(p_loss - j_loss) <= LOSS_ATOL
    assert abs(p_metrics["mAP"] - j_metrics["mAP"]) <= MAP_ATOL
    assert port_losses[4] != port_losses[0]  # the weights moved
