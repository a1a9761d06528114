"""Port vs reference: the analytic Americans
(``optpricer_tpu_torch/models/american_analytic.py``) and the American
implied vol (``models/binomial.american_implied_vol``), float64 on the CPU.

* Bjerksund-Stensland 2002, Barone-Adesi-Whaley and Roll-Geske-Whaley at
  rtol 1e-12 with an absolute floor of 1e-13 (1e-15 of the spot: the
  prices are differences of terms of size ~S0);
* ``american_implied_vol``: the crr and bs2002 inverses equal to the
  reference's at atol 1e-10, and the crr inverse of lattice prices
  recovers σ to 1e-8 (``tests/test_binomial.py:89``).
"""
import numpy as np
import pytest

from optpricer_tpu.models import american_analytic as ja
from optpricer_tpu.models import binomial as jb
from optpricer_tpu_torch.models import american_analytic as ta
from optpricer_tpu_torch.models import binomial as tb
from tests.torch_threads import torch_one_thread  # noqa: F401

CPU = dict(device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


def _book(seed, n=11):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(70.0, 130.0, n)), rng.uniform(0.1, 2.0, n),
            rng.uniform(0.15, 0.45, n))


@pytest.mark.parametrize("engine", ["bjerksund_stensland_price",
                                    "baw_price"])
@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("q", [0.0, 0.04, 0.08])
def test_american_closed_forms_match_reference(engine, kind, q):
    """q = 0 calls take the European branch, q = 0.08 > r calls exercise."""
    K, T, sig = _book(7)
    got = getattr(ta, engine)(100.0, K, T, 0.05, q, sigma=sig, kind=kind,
                              **CPU)
    _close(got, getattr(ja, engine)(100.0, K, T, 0.05, q, sigma=sig,
                                    kind=kind))


@pytest.mark.parametrize("D, t_div", [(4.0, 0.5), (0.2, 0.3), (8.0, 0.9)])
def test_rgw_matches_reference(D, t_div):
    """D = 0.2 is below K(1 − e^{−r(T−t)}): the European branch."""
    K = np.linspace(70.0, 130.0, 13)
    _close(ta.rgw_price(100.0, K, 1.0, 0.05, sigma=0.3, D=D, t_div=t_div,
                        **CPU),
           ja.rgw_price(100.0, K, 1.0, 0.05, sigma=0.3, D=D, t_div=t_div))
    with pytest.raises(ValueError):
        ta.rgw_price(100.0, K, 1.0, 0.05, sigma=0.3, D=D, t_div=1.0, **CPU)


def test_scalar_inputs_give_0d_tensors():
    got = ta.baw_price(100.0, 95.0, 1.0, 0.05, 0.0, sigma=0.3, kind="put",
                       **CPU)
    assert got.shape == ()
    assert float(got) == pytest.approx(
        float(ja.baw_price(100.0, 95.0, 1.0, 0.05, 0.0, sigma=0.3,
                           kind="put")), rel=1e-12)


def _chain(seed, n=16):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(80.0, 125.0, n))


@pytest.mark.parametrize("engine", ["crr", "bs2002"])
@pytest.mark.parametrize("kind", ["put", "call"])
def test_american_implied_vol_matches_reference(engine, kind):
    K = _chain(3)
    N = 64
    px = np.asarray(jb.crr_vec(100.0, K, 0.5, 0.03, 0.06, 0.27, kind, N=N,
                               american=True))
    got = tb.american_implied_vol(px, 100.0, K, 0.5, 0.03, 0.06, kind, N=N,
                                  engine=engine, **CPU)
    want = jb.american_implied_vol(px, 100.0, K, 0.5, 0.03, 0.06, kind, N=N,
                                   engine=engine)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-10)
    if engine == "crr":   # the round trip (tests/test_binomial.py:89)
        ok = ~np.isnan(got)
        assert ok.sum() >= len(K) - 2
        np.testing.assert_allclose(got[ok], 0.27, rtol=0.0, atol=1e-8)


def test_american_implied_vol_edges():
    K = np.array([80.0, 100.0, 120.0])
    px = np.array(jb.crr_vec(100.0, K, 1.0, 0.05, 0.0, 0.25, "put", N=32,
                             american=True))
    px[0] = 0.0                       # at intrinsic: unidentifiable
    px[2] = 120.0                     # at the cap
    got = tb.american_implied_vol(px, 100.0, K, 1.0, 0.05, N=32, **CPU)
    assert np.isnan(got[0]) and np.isnan(got[2])
    assert got[1] == pytest.approx(0.25, abs=1e-8)
    one = tb.american_implied_vol(float(px[1]), 100.0, 100.0, 1.0, 0.05,
                                  N=32, **CPU)
    assert isinstance(one, float) and one == pytest.approx(got[1], abs=0.0)
    with pytest.raises(ValueError):
        tb.american_implied_vol(px, 100.0, K, 1.0, 0.05, engine="baw", **CPU)
