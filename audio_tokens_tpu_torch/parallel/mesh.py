"""The data-parallel group (counterpart of ``audio_tokens_tpu/parallel/mesh.py``).

The JAX package shards batches over a ``data`` mesh axis and lets XLA
insert the ``psum``.  Here the axis is the ranks of the default process
group, one card each, and a ``DataGroup`` holds the collectives a
data-parallel step needs: the gradient all-reduce in one flat buffer, the
rank-ordered gather of predictions, the broadcast of rank 0's weights and
the sums of epoch statistics.  Only collectives that both backends have on
card and host tensors are used (``all_reduce``, ``broadcast`` and the list
form of ``all_gather``), through ``parallel/distributed``'s tensor
collectives: under gloo a card tensor goes through the host (ranks sharing
one card).

Tensor and sequence parallelism (``make_mesh`` with model or sequence
axes, ``tp_param_specs``, ``tp_shardings``) are ROADMAP A7.5.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from audio_tokens_tpu_torch.parallel import distributed


class DataGroup:
    """The ranks of one data-parallel program: every rank of the default
    process group, ``size`` of them, this one ``rank``."""

    def __init__(self):
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()

    def row_bounds(self, n_rows: int) -> tuple:
        """(lo, hi) of this rank's contiguous share of ``n_rows``."""
        return distributed.local_row_bounds(n_rows, self.rank, self.size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        return distributed.all_reduce_(t)

    def broadcast_(self, tensors: Iterable[torch.Tensor],
                   src: int = 0) -> None:
        """Rank ``src``'s values into ``tensors`` on every rank, in one
        flat buffer."""
        tensors = list(tensors)
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            distributed.broadcast_(flat, src)
            self._unflatten(flat, tensors)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        return distributed.all_gather(t, dim)

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]
                         ) -> None:
        """Sum the gradients over the ranks: one all-reduce of one flat
        buffer of every gradient (parameters without one are left
        without one on every rank alike)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        with torch.no_grad():
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.all_reduce_(flat)
            self._unflatten(flat, grads)

    @staticmethod
    def _unflatten(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def data_parallel_size(config, world: int) -> int:
    """The data group's size over ``world`` ranks: ``config.data_parallel``
    in the JAX meaning (``data_mesh``'s clamp), -1 all ranks, a larger value
    clamped to the world size, below 2 not data parallel (1).  The group
    spans every rank: a value between 2 and the world size is refused (a
    rank outside the group would train a replica of its own)."""
    want = getattr(config, "data_parallel", -1) if config is not None else -1
    want = world if want == -1 else min(want, world)
    if want < 2:
        return 1
    if want < world:
        raise ValueError(
            f"data_parallel={want} with {world} processes: the data group "
            "spans every rank (use -1 or at least the process count)")
    return want


def data_group(config=None) -> Optional[DataGroup]:
    """The data-parallel group of ``data_parallel_size`` ranks, or None
    below 2."""
    if not dist.is_initialized():
        return None
    if data_parallel_size(config, distributed.process_count()) < 2:
        return None
    return DataGroup()


def tp_param_specs(*args, **kwargs):
    raise NotImplementedError(
        "tensor-parallel shardings are not ported yet: ROADMAP A7.5")


def tp_shardings(*args, **kwargs):
    raise NotImplementedError(
        "tensor-parallel shardings are not ported yet: ROADMAP A7.5")
