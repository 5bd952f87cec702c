"""The two places where the classifiers meet an ensemble's member axis.

An ensemble (``train/ensemble.py``) runs one model's forward under
``torch.func.vmap`` over K members' stacked parameters.  Two things in the
models cannot be expressed member by member by vmap's own rules:

* **Dropout draws.**  Member i must draw exactly the keep-masks a single
  ``Trainer`` with ``random_seed=seeds[i]`` draws, from its own generator
  (the JAX ensemble vmaps each member's key).  A ``torch.Generator`` inside
  vmap gives one stream for all members.  So the models draw through
  ``uniform(shape, generator, device)``: for a ``torch.Generator`` it is
  ``torch.rand(shape, generator=generator)``, the single model's draw bit
  for bit; for ``MemberGenerators`` (K generators bound to the vmapped
  member index) its vmap rule draws member k's numbers from generator k,
  in the model's draw order.
* **Recompute** (``lstm_remat_chunk``, ``transformer_remat``).
  ``torch.utils.checkpoint`` does not run inside vmap.  ``remat(fn,
  *args, generator=...)`` is the recompute as one autograd function: its
  forward runs ``fn`` without keeping anything but its inputs, its
  backward runs ``fn`` again with gradients on (B3 with its residuals,
  then B4, for an lstm chunk) and differentiates that.  Its vmap rule
  calls it once a member on the member's slices, so autograd records one
  recompute a member and the backward needs no rule.  The generator's
  state (member k's under the member axis) is put back for the recompute
  and forward again after it, so the recomputed keep-masks are the
  forward's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from audio_tokens_tpu_torch.ops.common import members


class MemberGenerators:
    """K dropout generators, member k's at position k of the member axis,
    bound to the vmapped member index ``torch.arange(K)`` (which carries the
    member axis into the draw)."""

    def __init__(self, generators: Sequence[torch.Generator],
                 index: torch.Tensor):
        self.generators = list(generators)
        self.index = index

    def at(self, k: int, batch_size: int) -> torch.Generator:
        if batch_size != len(self.generators):
            raise ValueError(f"{len(self.generators)} member generators "
                             f"for a member axis of {batch_size}")
        return self.generators[k]


class _MemberUniform(torch.autograd.Function):
    @staticmethod
    def forward(index, gens, shape, device):
        # outside vmap: the one member the index names
        return torch.rand(shape, generator=gens.generators[int(index)],
                          device=device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, index, gens, shape, device):
        n = info.batch_size
        return torch.stack([torch.rand(shape, generator=gens.at(k, n),
                                       device=device) for k in range(n)]), 0


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` on ``device`` from ``generator``: a
    ``torch.Generator``, or ``MemberGenerators`` under the member axis."""
    if isinstance(generator, MemberGenerators):
        return _MemberUniform.apply(generator.index, generator, tuple(shape),
                                    device)
    return torch.rand(shape, generator=generator, device=device)


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(fn, generator, state, *args):
        return fn(generator, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, generator, state, *args = inputs
        ctx.set_materialize_grads(False)
        ctx.fn, ctx.generator, ctx.state = fn, generator, state
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*tensors)
        ctx.slots = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if s else a for a, s in zip(args, ctx.slots)]

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        need = ctx.needs_input_grad[3:]
        args = [next(saved).detach().requires_grad_(n) if s else o
                for s, o, n in zip(ctx.slots, ctx.others, need)]
        gen = ctx.generator
        with torch.enable_grad():
            if gen is None:
                outs = ctx.fn(gen, *args)
            else:
                found = gen.get_state()
                gen.set_state(ctx.state)
                try:
                    outs = ctx.fn(gen, *args)
                finally:
                    gen.set_state(found)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [a for a, n in zip(args, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        return (None, None, None,
                *(next(got, None) if n else None for n in need))

    @staticmethod
    def vmap(info, in_dims, fn, generator, state, *args):
        n = info.batch_size
        rows = zip(*(members(a, d, n) for a, d in zip(args, in_dims[3:])))
        outs = []
        for k, row in enumerate(rows):
            gen = (generator.at(k, n)
                   if isinstance(generator, MemberGenerators) else generator)
            outs.append(remat(fn, *row, generator=gen))
        if isinstance(outs[0], tuple):
            stacked = tuple(torch.stack(o) for o in zip(*outs))
            return stacked, (0,) * len(stacked)
        return torch.stack(outs), 0


def remat(fn, *args, generator=None):
    """``fn(generator, *args)`` (a tensor or a tuple of tensors), whose
    backward recomputes it from ``args`` instead of keeping what it made.
    ``generator``: None, a ``torch.Generator`` (replayed for the recompute)
    or ``MemberGenerators``."""
    state = (generator.get_state()
             if isinstance(generator, torch.Generator) else None)
    return _Remat.apply(fn, generator, state, *args)
