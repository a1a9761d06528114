"""The port's pathwise MLMC Greeks under Heston dynamics
(``mlmc_price(heston=..., greeks=True)``) against
tests/test_mlmc.py::TestGreeks::test_heston_vanilla_delta_and_v0's oracle
and tolerances: ``heston_greeks_cos``' delta within 4 se + 0.01 and
∂V/∂v0 within 4 se + 10 %, at eps 0.015, seed 35.
"""
import optpricer_tpu_torch as tp
from tests.torch_threads import torch_one_thread  # noqa: F401

S0, K, T, R, Q = 100.0, 100.0, 1.0, 0.05, 0.0
HP = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.3, rho=-0.5)


def _mlmc(payoff, **kw):
    return tp.mlmc_price(payoff, S0, K, T, R, Q, device="cpu", **kw)


def test_greeks_heston_delta_and_v0():
    hg = tp.heston_greeks_cos(S0, K, T, R, Q, **HP, kind="call",
                              device="cpu")
    px, se, g, info = _mlmc("vanilla", heston=HP, eps=0.015, seed=35,
                            greeks=True, return_info=True)
    assert abs(g["delta"] - float(hg["delta"])) \
        < 4.0 * g["delta_stderr"] + 0.01, (g, hg)
    assert abs(g["d_v0"] - float(hg["vega_v0"])) \
        < 4.0 * g["d_v0_stderr"] + 0.1 * abs(float(hg["vega_v0"]))
