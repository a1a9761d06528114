"""The PDE engines' log-spot grid, shared by ``models/pde.py``,
``models/fem.py`` and the fused local-vol march (``ops/fd_lv.py``).

Counterpart of ``_build_grid`` in ``optpricer_tpu/models/pde.py``; host
float64, as in the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["build_grid"]


def build_grid(S0, T, sigma, N_S, N_t, S_max_mult):
    """Uniform log-spot grid x ∈ ln(S0) ± S_max_mult·σ√T: (x, dx, dt)."""
    x_range = S_max_mult * sigma * np.sqrt(T)
    x_min = np.log(S0) - x_range
    x_max = np.log(S0) + x_range
    x_grid = np.linspace(x_min, x_max, N_S + 1)
    dx = x_grid[1] - x_grid[0]
    dt = T / N_t
    return x_grid, dx, dt
