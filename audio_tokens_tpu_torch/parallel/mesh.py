"""The process mesh (counterpart of ``audio_tokens_tpu/parallel/mesh.py``).

The JAX package shards batches over a ``data`` mesh axis, activations over
a ``sequence`` axis and transformer weights over a ``model`` axis, and
lets XLA insert the collectives.  Here one process holds one card, the
mesh is a layout of the ranks, and each axis is a process group: a
``DataGroup`` holds the collectives a step needs over its ranks (the
gradient all-reduce in one flat buffer, the rank-ordered gather of
predictions, the broadcast of rank 0's weights, the sums of epoch
statistics).  ``data_group`` is the data-only mesh of data parallelism,
every rank; ``make_mesh`` lays the ranks out (data, sequence, model) for
tensor and sequence parallelism (``models/transformer.py``), and
``tp_param_specs`` / ``tp_shardings`` / ``tp_gather`` split the
transformer's weights over its ``model`` axis and join them again.

Only collectives that both backends have on card and host tensors are
used (``all_reduce``, ``broadcast`` and the list form of ``all_gather``),
through ``parallel/distributed``'s tensor collectives: under gloo a card
tensor goes through the host (ranks sharing one card).  Gloo has no
reduce-scatter of these tensors, so the backward of a gather is an
all-reduce and a slice.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from audio_tokens_tpu_torch.parallel import distributed


class DataGroup:
    """The ranks of one axis of the mesh: a process group (``None``: every
    rank of the default group), ``size`` of them, this one ``rank`` (its
    place in the group).  Outside a process group it is one rank, and
    every collective is the identity."""

    def __init__(self, group=None):
        self.group = group
        self.alone = not dist.is_initialized()
        if self.alone:
            self.size, self.rank = 1, 0
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)

    def row_bounds(self, n_rows: int) -> tuple:
        """(lo, hi) of this rank's contiguous share of ``n_rows``."""
        return distributed.local_row_bounds(n_rows, self.rank, self.size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.alone:
            return t
        return distributed.all_reduce_(t, self.group)

    def broadcast_(self, tensors: Iterable[torch.Tensor],
                   src: int = 0) -> None:
        """Rank ``src``'s values into ``tensors`` on every rank, in one
        flat buffer."""
        tensors = list(tensors)
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            if not self.alone:
                distributed.broadcast_(flat, src, self.group)
            self._unflatten(flat, tensors)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.alone:
            return t
        return distributed.all_gather(t, dim, self.group)

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


class Mesh:
    """The ranks laid out (data, sequence, model), ``model`` innermost, as
    the JAX ``make_mesh`` reshapes its devices: rank ``(d S + s) M + m``
    holds place ``(d, s, m)``.  ``data``, ``sequence`` and ``model`` are
    this rank's groups of the three axes, and ``replica`` the ranks of its
    model place (data x sequence): the group a gradient is summed over.
    ``shape`` is the JAX mesh's (no ``sequence`` axis when it has one
    place)."""

    def __init__(self, data: DataGroup, sequence: DataGroup,
                 model: DataGroup, replica: DataGroup):
        self.data, self.sequence, self.model = data, sequence, model
        self.replica = replica
        sizes = {"data": data.size, "sequence": sequence.size,
                 "model": model.size}
        if sequence.size == 1:
            del sizes["sequence"]
        self.shape = sizes
        self.size = data.size * sequence.size * model.size


def make_mesh(data: int = -1, model: int = 1, seq: int = 1) -> Mesh:
    """The mesh of ``data`` x ``seq`` x ``model`` ranks over the process
    group (one rank outside one), with the JAX ``make_mesh``'s arguments
    and errors: ``data=-1`` takes world / (model x seq) and the world must
    divide by model x seq; a mesh larger than the world is refused, and so
    is one smaller (a rank outside the mesh would have no program).

    Every rank makes every group of every axis, in one fixed order, as
    ``dist.new_group`` asks, and keeps its own."""
    n = distributed.process_count()
    if data == -1:
        if n % (model * seq):
            raise ValueError(
                f"{n} devices not divisible by model={model} x seq={seq}")
        data = n // (model * seq)
    if data * model * seq > n:
        raise ValueError(f"mesh {data}x{seq}x{model} exceeds {n} devices")
    if data * model * seq < n:
        raise ValueError(
            f"mesh {data}x{seq}x{model} covers {data * model * seq} of the "
            f"{n} processes: every process must hold a place in it")
    if not dist.is_initialized():
        return Mesh(DataGroup(), DataGroup(), DataGroup(), DataGroup())
    grid = torch.arange(data * seq * model).view(data, seq, model)
    rank = dist.get_rank()
    mine = {}
    # (axis, the grid with that axis last): each row a group
    for axis, rows in (
            ("model", grid.reshape(-1, model)),
            ("sequence", grid.permute(0, 2, 1).reshape(-1, seq)),
            ("data", grid.permute(1, 2, 0).reshape(-1, data)),
            ("replica", grid.permute(2, 0, 1).reshape(model, -1))):
        for row in rows.tolist():
            group = dist.new_group(row)
            if rank in row:
                mine[axis] = DataGroup(group)
    mesh = Mesh(mine["data"], mine["sequence"], mine["model"],
                mine["replica"])
    assert (mesh.data.rank, mesh.sequence.rank, mesh.model.rank) == (
        rank // (seq * model), rank // model % seq, rank % model)
    return mesh


def data_axis(mesh) -> DataGroup:
    """The ranks a batch splits over: a ``Mesh``'s data axis, or a
    ``DataGroup`` itself (one process a card: the group is the mesh)."""
    if isinstance(mesh, Mesh):
        return mesh.data
    if isinstance(mesh, DataGroup):
        return mesh
    raise TypeError(f"mesh must be a Mesh or a DataGroup, got "
                    f"{type(mesh).__name__}")


def tp_param_specs(model, rules=None) -> dict:
    """{parameter name: the dimension it splits along over the ``model``
    axis, or None (replicated)} for a module (or a state dict) from
    (name-substring, dimension) ``rules``, the first that matches
    (default: ``models/transformer.TP_RULES``); the JAX ``tp_param_specs``
    on the port's names and layouts."""
    if rules is None:
        from audio_tokens_tpu_torch.models.transformer import TP_RULES
        rules = TP_RULES
    named = (model.named_parameters() if isinstance(model, torch.nn.Module)
             else model.items())
    specs = {}
    for name, p in named:
        specs[name] = None
        for substr, dim in rules:
            if substr in name:
                if dim >= p.dim():
                    raise ValueError(f"rule {substr}: dimension {dim} of a "
                                     f"{p.dim()}-d param {name}")
                specs[name] = dim
                break
    return specs


def tp_shardings(mesh: Mesh, model, rules=None) -> dict:
    """{parameter name: this rank's slice} of a module's (or a state
    dict's) full tensors: those ``tp_param_specs`` splits cut into
    ``mesh.model.size`` equal pieces along their dimension, piece
    ``mesh.model.rank``; the others whole."""
    named = dict(model.named_parameters() if isinstance(model, torch.nn.Module)
                 else model.items())
    tp, r = mesh.model.size, mesh.model.rank
    out = {}
    for name, dim in tp_param_specs(named, rules).items():
        t = named[name]
        if dim is not None:
            if t.shape[dim] % tp:
                raise ValueError(f"{name}: dimension {dim} of "
                                 f"{tuple(t.shape)} does not split over "
                                 f"{tp} model ranks")
            t = t.chunk(tp, dim)[r]
        out[name] = t
    return out


def tp_gather(mesh: Mesh, tensors: dict, specs: dict) -> dict:
    """The inverse of ``tp_shardings``: every rank's slices of the split
    tensors joined in model-rank order (a collective over the ``model``
    axis), the others as they are."""
    return {name: t if specs.get(name) is None
            else mesh.model.all_gather(t.detach(), specs[name])
            for name, t in tensors.items()}
