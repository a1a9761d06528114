"""The one request generator. A traffic mix is a data file
(``traffic/<mix>.json``); this module reads it and draws the mix's requests
from the run's seed, so a new mix is a new data file.

A mix gives ``fixed`` fields, per-request ``draws`` and optional
``groups`` of contracts (a book, a ladder), each group ``n`` rows whose
fields are a number or string (every row alike) or a spec:

* ``{"uniform": [lo, hi]}``: drawn uniformly;
* ``{"linspace": [lo, hi]}``: evenly spaced over the group's rows;
* ``{"cycle": [a, b, ...]}``: repeated in order over the group's rows.

A request is a dict: the configuration's ``market``, then the mix's
``fixed`` fields, then its draws, then each group field as an array over
all groups' rows, and ``mc_seed``, a fresh stream key for the program.
"""
from __future__ import annotations

import numpy as np

# the program keys its streams by seed mod 2^31 - 1
MAX_MC_SEED = 2**31 - 2

# independent streams of one run's seed
WINDOW, WARMUP, SAMPLE, REFERENCE = range(4)


def stream(seed: int, which: int) -> np.random.Generator:
    """The generator of stream ``which`` of the run's ``seed`` (any whole
    number; negative ones are taken mod 2^64)."""
    return np.random.default_rng([int(seed) % 2**64, which])


def _value(spec, rng, n=None):
    if not isinstance(spec, dict):
        return spec if n is None else np.full(n, spec)
    (kind, args), = spec.items()
    if kind == "uniform":
        lo, hi = args
        return float(rng.uniform(lo, hi)) if n is None else rng.uniform(lo, hi,
                                                                         n)
    if n is None:
        raise ValueError(f"{kind!r} needs a group's rows")
    if kind == "linspace":
        lo, hi = args
        return np.linspace(lo, hi, n)
    if kind == "cycle":
        return np.array([args[i % len(args)] for i in range(n)])
    raise ValueError(f"unknown draw {kind!r}")


class Requests:
    """The endless, seed-determined sequence of one mix's requests."""

    def __init__(self, config: dict, traffic: dict, seed: int, which: int):
        self.base = {**config.get("market", {}), **traffic.get("fixed", {})}
        self.draws = traffic.get("draws", {})
        self.groups = traffic.get("groups", [])
        self.rng = stream(seed, which)
        self.index = 0

    def next(self) -> dict:
        rng = self.rng
        req = dict(self.base, index=self.index,
                   mc_seed=int(rng.integers(0, MAX_MC_SEED + 1)))
        for name, spec in self.draws.items():
            req[name] = _value(spec, rng)
        if self.groups:
            cols = {}
            for group in self.groups:
                for name, spec in group.items():
                    if name != "n":
                        cols.setdefault(name, []).append(
                            _value(spec, rng, group["n"]))
            req.update({name: np.concatenate(parts)
                        for name, parts in cols.items()})
        self.index += 1
        return req

    def take(self, n: int) -> list:
        return [self.next() for _ in range(n)]


def contracts(request: dict) -> int:
    """Contracts priced by one request: its rows, or 1."""
    return int(len(request["K"])) if np.ndim(request.get("K", 0)) else 1
