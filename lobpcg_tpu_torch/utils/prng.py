"""Explicit-generator random fills (port of ``lobpcg_tpu/utils/prng.py``).

Every random fill takes an explicit ``torch.Generator``.  Torch and JAX
give different numbers from the same seed, so a solver also accepts a
``draws`` mapping of precomputed arrays that stand in for the generator
(``Draws``): the parity tests reproduce the JAX package's key split and
hand both packages the same bytes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def fill_random(generator: Optional[torch.Generator], shape, dtype,
                device) -> torch.Tensor:
    """Uniform [-0.5, 0.5]; complex dtypes get independent re/im parts."""
    if dtype.is_complex:
        rdt = dtype.to_real()
        re = torch.rand(shape, generator=generator, dtype=rdt, device=device)
        im = torch.rand(shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(re - 0.5, im - 0.5).to(dtype)
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=device) - 0.5


class Draws:
    """The solver's named random fills: ``fill(name, shape, dtype,
    device)`` returns ``draws[name]`` when the caller supplied it, and a
    fresh ``fill_random`` from the generator otherwise.

    Names: ``"norm_a"`` / ``"norm_b"`` (the [n, norm_block] power
    iteration starts), ``"x0"`` (the start block when X0 is None),
    ``"refill"`` (robust_basis_init's refill block), ``"stall{it}"``
    (the stall-reset noise at iteration ``it``).
    """

    def __init__(self, generator: Optional[torch.Generator],
                 draws: Optional[Mapping] = None):
        self.generator = generator
        self.draws = dict(draws or {})

    def fill(self, name: str, shape, dtype, device) -> torch.Tensor:
        given = self.draws.get(name)
        if given is None:
            return fill_random(self.generator, shape, dtype, device)
        if not isinstance(given, torch.Tensor):
            given = torch.from_numpy(np.array(given))
        t = given.to(device=device, dtype=dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"draw {name!r} has shape {tuple(t.shape)}, expected "
                f"{tuple(shape)}"
            )
        return t
