"""Port vs reference: the pathwise MLMC Greeks' tangents.

``_mlmc_level_stats(greek_params=...)`` (one ``torch.func.jacfwd``
through ``_level_y``, the chunk's draws made first, outside the
differentiated function) fed the reference's own draws, against the
reference's ``jax.linearize`` and one replay per parameter, at every
dynamics and payoff of ``test_torch_mlmc.py`` but the digital (no pathwise
derivative): each [Σ∂Y, Σ(∂Y)²] pair at rtol 1e-10 (``_stats_close``), in
float64, on a correction level. GBM differentiates (S0, σ, r), Heston
(S0, r, v0), local vol (S0, r).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from optpricer_tpu.models import mlmc as jml
from optpricer_tpu_torch.models import mlmc as tml
from tests.test_torch_mlmc import (CASES, N, _fixed_pair, _ref_draw,
                                   _sigma_locs, _static, _stats_close)
from tests.torch_threads import torch_one_thread  # noqa: F401

F64 = jnp.float64
GREEKS = {"gbm": ("S0", "sigma", "r"), "heston": ("S0", "r", "h_v0"),
          "localvol": ("S0", "r")}


@pytest.mark.parametrize("case", [c for c in sorted(CASES)
                                  if "digital" not in c])
def test_greek_tangents_match_reference(case):
    mk, _, fixed_over, _ = CASES[case]
    jf, tf = _fixed_pair(**fixed_over)
    static = _static(case, False)
    sj, st = _sigma_locs(mk)
    key = jax.random.key(5)
    want = jml._mlmc_level_stats(key, jf, greek_params=GREEKS[mk],
                                 dtype=F64, **sj, **static)
    got = tml._mlmc_level_stats(_ref_draw(key, N, mk == "heston"), tf,
                                greek_params=GREEKS[mk],
                                dtype=torch.float64, **st, **static)
    _stats_close(got, want, 1e-10, case)
