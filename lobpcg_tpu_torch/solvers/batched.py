"""Batched solves: the counterpart of ``jax.vmap(fn)`` over dim 0, as the
JAX package's ``tests/test_vmap.py`` maps its solvers over a stack of
problems (a parameter sweep, such as BdG spectra against the interaction
strength, on one card).

``batched(solve)(A_batch, shifts)`` calls ``solve`` once per slice of the
leading dimension of its tensor arguments and stacks what it returns.
Under ``jax.vmap`` the JAX package's ``lax.while_loop`` becomes one
program whose iterations are masked per problem.  That program is the
port's lockstep route: ``lobpcg``/``ilobpcg`` given an X0 of [b, n, m]
(``solvers/lobpcg.py``) run the batch as one loop, one set of launches
for the batch, with per-problem masks.  That route takes every operator
``jax.vmap`` maps in the JAX package: those of ``operators/linop.py``
(``CallableOperator`` with its arguments shared or mapped by
``in_axes``), ``LaplacianND`` and ``BSROperator`` over a grid or matrix
the batch shares (one K2, K3 or K5 launch a batch apply), the realified
operators, the sharded forms of ``parallel/`` (a sweep under a row
group: X0 [b, n_loc, m] on each rank), and a P0 [n, m] the batch
shares; not a P0 per problem (which ``jax.vmap`` of the JAX solve
refuses too).  ``batched`` stays the generic map for any function
(and for what the lockstep route does not take): each problem runs the
unbatched host loop on the card, one after another, and gets exactly
its own solve's result.

Random draws: ``jax.vmap`` over a solve with an unbatched key gives every
problem the same draws.  Pass the generators the solve draws from as
``generators=``: their states are restored before each problem, so a
batch solved from ``X0=None`` gives each problem a lone solve's result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


def _stack(outs: list):
    """One output of the batch's shape from the problems' outputs: tensors
    and Python numbers gain a leading batch dimension; tuples (named too),
    lists, dicts and dataclasses are stacked field by field; None stays
    None."""
    first = outs[0]
    if first is None:
        if any(o is not None for o in outs):
            raise ValueError("batched: an output is None for some problems only")
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, (bool, int, float)):
        return torch.tensor(outs)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(f)) for f in zip(*outs)))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(f)) for f in zip(*outs))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(first) if f.init})
    raise TypeError(f"batched: cannot stack an output of type "
                    f"{type(first).__name__}")


def batched(fn: Callable, generators: Sequence[torch.Generator] = ()) -> Callable:
    """``fn`` mapped over dim 0 of its tensor arguments (positional and
    keyword; other arguments go to every call unchanged), its outputs
    stacked along a new dim 0: ``jax.vmap(fn)`` with ``in_dims=0``.

    ``generators``: restored to their states at the call before each
    problem, as an unbatched key gives every problem the same draws.
    """
    generators = tuple(generators)

    def run(*args, **kwargs):
        sizes = {a.shape[0] for a in (*args, *kwargs.values())
                 if isinstance(a, torch.Tensor)}
        if len(sizes) != 1:
            raise ValueError(f"batched: the tensor arguments need one common "
                             f"leading size, got {sorted(sizes)}")
        (size,) = sizes
        states = [g.get_state() for g in generators]

        def pick(a, i):
            return a[i] if isinstance(a, torch.Tensor) else a

        outs = []
        for i in range(size):
            for g, state in zip(generators, states):
                g.set_state(state)
            outs.append(fn(*(pick(a, i) for a in args),
                           **{k: pick(v, i) for k, v in kwargs.items()}))
        return _stack(outs)

    return run
