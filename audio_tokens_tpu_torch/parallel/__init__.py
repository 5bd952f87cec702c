"""Multi-process and data-parallel execution on ``torch.distributed``
(counterpart of ``audio_tokens_tpu/parallel/``)."""

from audio_tokens_tpu_torch.parallel.mesh import DataGroup, data_group

__all__ = ["DataGroup", "data_group"]
