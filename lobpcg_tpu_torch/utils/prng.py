"""Explicit-generator random fills (port of ``lobpcg_tpu/utils/prng.py``).

Every random fill takes an explicit ``torch.Generator``.  Torch and JAX
give different numbers from the same seed, so a solver also accepts a
``draws`` mapping of precomputed arrays that stand in for the generator
(``Draws``): the parity tests reproduce the JAX package's key split and
hand both packages the same bytes.

A fill is made in chunks of ``DRAW_CHUNK_ROWS`` global rows, one
generator call each, in row order.  A rank of a row-sharded solve makes
the same calls and keeps its rows of each chunk, so it holds one chunk
at a time, never the global block, and gets the bits the unsharded
solve draws.  (On the CPU the chunks also give the bits of one call.)
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

DRAW_CHUNK_ROWS = 1 << 16


def _uniform_rows(generator, shape, dtype, device, rows: slice,
                  chunk_rows: int) -> torch.Tensor:
    """Rows ``rows`` of a [shape] uniform [0, 1) fill drawn chunk by chunk."""
    n, tail = shape[0], tuple(shape[1:])
    r0, r1, _ = rows.indices(n)
    out = torch.empty((max(r1 - r0, 0),) + tail, dtype=dtype, device=device)
    for c0 in range(0, n, chunk_rows):
        c1 = min(c0 + chunk_rows, n)
        t = torch.rand((c1 - c0,) + tail, generator=generator, dtype=dtype,
                       device=device)
        lo, hi = max(c0, r0), min(c1, r1)
        if lo < hi:
            out[lo - r0 : hi - r0] = t[lo - c0 : hi - c0]
    return out


def fill_random(generator: Optional[torch.Generator], shape, dtype, device,
                rows: Optional[slice] = None,
                chunk_rows: int = DRAW_CHUNK_ROWS) -> torch.Tensor:
    """Uniform [-0.5, 0.5]; complex dtypes get independent re/im parts.
    ``rows``: only these rows of the [shape] fill (all by default)."""
    rows = slice(None) if rows is None else rows
    if dtype.is_complex:
        rdt = dtype.to_real()
        re = _uniform_rows(generator, shape, rdt, device, rows, chunk_rows)
        im = _uniform_rows(generator, shape, rdt, device, rows, chunk_rows)
        return torch.complex(re - 0.5, im - 0.5).to(dtype)
    return _uniform_rows(generator, shape, dtype, device, rows, chunk_rows) - 0.5


class Draws:
    """The solver's named random fills: ``fill(name, shape, dtype,
    device)`` returns ``draws[name]`` when the caller supplied it, and a
    fresh ``fill_random`` from the generator otherwise.

    Names: ``"norm_a"`` / ``"norm_b"`` (the [n, norm_block] power
    iteration starts), ``"x0"`` (the start block when X0 is None),
    ``"refill"`` (robust_basis_init's refill block), ``"stall{it}"``
    (the stall-reset noise at iteration ``it``).

    ``rows`` (a slice, for a rank of a row-sharded solve): ``shape`` is
    the global shape and each fill is this rank's rows of the global
    fill, made without holding the global block on the device.
    """

    def __init__(self, generator: Optional[torch.Generator],
                 draws: Optional[Mapping] = None,
                 rows: Optional[slice] = None):
        self.generator = generator
        self.draws = dict(draws or {})
        self.rows = rows

    def fill(self, name: str, shape, dtype, device) -> torch.Tensor:
        given = self.draws.get(name)
        if given is None:
            return fill_random(self.generator, shape, dtype, device, self.rows)
        if not isinstance(given, torch.Tensor):
            given = np.asarray(given)
        if tuple(given.shape) != tuple(shape):
            raise ValueError(
                f"draw {name!r} has shape {tuple(given.shape)}, expected "
                f"{tuple(shape)}"
            )
        if self.rows is not None:  # cut on the host, before the copy
            given = given[self.rows]
        if not isinstance(given, torch.Tensor):
            given = torch.from_numpy(np.array(given))
        return given.to(device=device, dtype=dtype)
