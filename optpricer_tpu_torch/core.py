"""Contract and market-data containers.

Counterpart of ``optpricer_tpu/core.py``: ``OptionSpec`` / ``Instrument`` /
``MarketData`` with the same construction-time validation. The JAX package
registers them as pytrees; here they are plain dataclasses, and an engine
reads their fields as Python floats (or tensors, for array-valued fields).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

CALL = "call"
PUT = "put"


@dataclass(frozen=True)
class OptionSpec:
    """Single-option container bundling instrument + market data."""

    S0: float
    K: float
    T: float          # years
    r: float          # continuous risk-free
    sigma: float
    q: float = 0.0    # continuous dividend yield

    def __post_init__(self):
        for name in ("S0", "K", "T", "sigma"):
            v = getattr(self, name)
            # array-valued fields are validated by the engines that use them
            if isinstance(v, (int, float)) and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")


@dataclass(frozen=True)
class Instrument:
    """What the contract *is* — static terms."""

    K: float
    T: float
    kind: str = CALL
    exercise: str = "european"

    def __post_init__(self):
        for name in ("K", "T"):
            v = getattr(self, name)
            if isinstance(v, (int, float)) and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if self.kind not in (CALL, PUT):
            raise ValueError(f"kind must be 'call' or 'put', got {self.kind!r}")
        if self.exercise not in ("european", "american"):
            raise ValueError(
                f"exercise must be 'european' or 'american', got {self.exercise!r}"
            )


@dataclass(frozen=True)
class MarketData:
    """What is *moving* — spot/rate/yield plus an optional calibrated
    surface (any object with an ``iv(K, T)`` method)."""

    spot: float
    rate: float
    q: float = 0.0
    vol_surface: Any = None
    flat_vol: float = 0.0

    def iv(self, K: float, T: float) -> float:
        """Implied vol — from the surface if one is set, else flat."""
        if self.vol_surface is not None:
            return float(self.vol_surface.iv(K, T))
        return self.flat_vol


def to_instrument_market(opt: OptionSpec, kind: str = CALL):
    """Decompose an ``OptionSpec`` into the (Instrument, MarketData) pair."""
    inst = Instrument(K=opt.K, T=opt.T, kind=kind)
    mkt = MarketData(spot=opt.S0, rate=opt.r, q=opt.q, flat_vol=opt.sigma)
    return inst, mkt
