"""Port vs reference: the Lévy models of ``optpricer_tpu_torch/models/
levy.py``, float64 on the CPU.

* VG, NIG and CGMY COS prices at rtol 1e-10 with atol 1e-12 (the complex
  matvec sums in another order than the reference's);
* the path cores fed the reference's own draws — its
  ``jax.random.split`` / ``gamma`` / ``normal`` / ``uniform`` calls on the
  key that ``vg_paths`` / ``nig_paths`` derive from the seed — equal to
  the reference's paths at rtol 1e-12, and the inverse-Gaussian core
  equal to the reference's ``_sample_ig`` on the same key;
* ``fit_vg`` within 1e-6 of the reference's fit, rmse < 1e-6 on a smile
  generated from known parameters;
* the port's own samplers statistically: the gamma draws' mean and
  variance within 5 standard errors, the discounted mean of S_T within 4
  se of S0·e^{−qT}, and the vanilla from the last row within 4 se + 1e-3
  of its COS price.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import levy as jl
from optpricer_tpu_torch.models import levy as tl
from tests.torch_threads import torch_one_thread  # noqa: F401

CPU = dict(device="cpu")
VG = dict(sigma=0.2, theta=-0.14, nu=0.2)
NIG = dict(alpha=8.0, beta=-4.0, delta=0.4)
MKT = (100.0, 0.5, 0.03, 0.01)          # S0, T, r, q


def _t(v):
    return torch.as_tensor(np.array(v, np.float64))


def _cos_case(model, lib, K, kind, **kw):
    S0, T, r, q = MKT
    if model == "vg":
        return lib.vg_price_cos(S0, K, T, r, q, **VG, kind=kind, **kw)
    if model == "nig":
        return lib.nig_price_cos(S0, K, T, r, q, **NIG, kind=kind, **kw)
    Y = float(model.split()[1])
    return lib.cgmy_price_cos(S0, K, T, r, q, C=0.5, G=5.0, M=9.0, Y=Y,
                              kind=kind, **kw)


@pytest.mark.parametrize("model", ["vg", "nig", "cgmy 0.5", "cgmy 1.5"])
@pytest.mark.parametrize("kind", ["call", "put"])
def test_cos_matches_reference(model, kind):
    K = np.sort(np.random.default_rng(2).uniform(60.0, 140.0, 11))
    got = _cos_case(model, tl, K, kind, **CPU)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_cos_case(model, jl, K, kind)),
                               rtol=1e-10, atol=1e-12)
    one = _cos_case(model, tl, float(K[3]), kind, **CPU)
    assert one.shape == () and float(one) == pytest.approx(float(got[3]),
                                                           rel=1e-12)


def test_parameter_gates_match_reference():
    S0, T, r, q = MKT
    for bad in (dict(Y=1.0), dict(Y=2.5), dict(M=0.9), dict(C=-1.0)):
        kw = dict(C=0.5, G=5.0, M=9.0, Y=0.8) | bad
        for lib, extra in ((jl, {}), (tl, CPU)):
            with pytest.raises(ValueError):
                lib.cgmy_price_cos(S0, 100.0, T, r, q, **kw, **extra)
    with pytest.raises(ValueError):
        tl.vg_paths(S0, T, r, q, sigma=0.2, theta=2.0, nu=1.0, **CPU)
    for bad in (dict(beta=-9.5), dict(alpha=2.0, beta=-2.5),
                dict(delta=0.0)):
        with pytest.raises(ValueError):
            tl.nig_paths(S0, T, r, q, **(NIG | bad), **CPU)


@pytest.mark.parametrize("antithetic", [True, False])
def test_vg_core_on_reference_draws(antithetic):
    S0, T, r, q = MKT
    seed, n_steps, n_paths = 11, 12, 40
    k_g, k_z = jax.random.split(jax.random.key(seed))
    dt = T / n_steps
    g = jax.random.gamma(k_g, jnp.asarray(dt / VG["nu"], jnp.float64),
                         (n_steps, n_paths), jnp.float64) * VG["nu"]
    Z = jax.random.normal(k_z, (n_steps, n_paths), jnp.float64)
    got = tl._vg_core(_t(g), _t(Z), *map(_t, (S0, T, r, q, VG["sigma"],
                                              VG["theta"], VG["nu"])),
                      antithetic=antithetic)
    want = jl.vg_paths(S0, T, r, q, **VG, n_steps=n_steps, n_paths=n_paths,
                       antithetic=antithetic, seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0.0)


@pytest.mark.parametrize("antithetic", [True, False])
def test_nig_core_on_reference_draws(antithetic):
    S0, T, r, q = MKT
    seed, n_steps, n_paths = 13, 12, 40
    shape = (n_steps, n_paths)
    k_ig, k_z = jax.random.split(jax.random.key(seed))
    k_n, k_u = jax.random.split(k_ig)
    Zc = jax.random.normal(k_n, shape, jnp.float64)
    U = jax.random.uniform(k_u, shape, jnp.float64)
    Z = jax.random.normal(k_z, shape, jnp.float64)
    params = [_t(v) for v in (NIG["alpha"], NIG["beta"], NIG["delta"])]
    mu, lam = tl._nig_clock(_t(T), *params, n_steps)
    I = tl._ig_core(_t(Zc), _t(U), mu, lam)
    I_ref = jl._sample_ig(k_ig, jnp.asarray(float(mu)),
                          jnp.asarray(float(lam)), shape, jnp.float64)
    np.testing.assert_allclose(I.numpy(), np.asarray(I_ref), rtol=1e-12,
                               atol=0.0)
    got = tl._nig_core(I, _t(Z), *map(_t, (S0, T, r, q)), *params,
                       antithetic=antithetic)
    want = jl.nig_paths(S0, T, r, q, **NIG, n_steps=n_steps,
                        n_paths=n_paths, antithetic=antithetic, seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0.0)


def test_fit_vg_recovers_reference_fit():
    from optpricer_tpu_torch.ops.black_scholes import bs_implied_vol_vec

    S0, T, r, q = MKT
    K = np.linspace(85.0, 115.0, 9)
    Tv = np.full(9, T)
    px = tl.vg_price_cos(S0, K, T, r, q, **VG, N=128, **CPU)
    iv = bs_implied_vol_vec(S0, K, Tv, r, q, px, "call", **CPU).numpy()
    got = tl.fit_vg(K, Tv, iv, S0, r, q, **CPU)
    want = jl.fit_vg(K, Tv, iv, S0, r, q)
    assert got["rmse"] < 1e-6
    for name in ("sigma", "theta", "nu"):
        assert abs(got[name] - want[name]) < 1e-6, name
        assert abs(got[name] - VG[name]) < 1e-6, name


@pytest.mark.parametrize("a", [0.02, 0.3, 1.0, 2.5, 40.0])
def test_standard_gamma_moments(a):
    n = 200_000
    g = tl._standard_gamma(torch.Generator().manual_seed(5), a, (n,),
                           torch.float64, "cpu")
    assert g.shape == (n,) and bool((g >= 0.0).all())
    # Γ(a, 1): mean a, variance a, fourth central moment 3a² + 6a
    se_mean = np.sqrt(a / n)
    se_var = np.sqrt((3 * a * a + 6 * a - a * a) / n)
    assert abs(float(g.mean()) - a) < 5 * se_mean
    assert abs(float(g.var()) - a) < 5 * se_var


@pytest.mark.parametrize("model", ["vg", "nig"])
def test_path_samplers_price_the_cos_vanilla(model):
    S0, T, r, q = MKT
    kw = dict(n_steps=16, n_paths=60_000, seed=21, **CPU)
    if model == "vg":
        paths = tl.vg_paths(S0, T, r, q, **VG, **kw)
        cos = tl.vg_price_cos(S0, 100.0, T, r, q, **VG, **CPU)
    else:
        paths = tl.nig_paths(S0, T, r, q, **NIG, **kw)
        cos = tl.nig_price_cos(S0, 100.0, T, r, q, **NIG, **CPU)
    assert paths.shape == (17, 120_000) and paths.dtype == torch.float64
    assert bool((paths[0] == S0).all())
    # antithetic pairs: the two halves share the clock, so the mean of a
    # pair is one sample
    ST = paths[-1].numpy()
    pairs = 0.5 * (ST[:60_000] + ST[60_000:])
    disc = np.exp(-r * T) * pairs
    assert abs(disc.mean() - S0 * np.exp(-q * T)) < \
        4 * disc.std() / np.sqrt(len(disc))
    pay = np.exp(-r * T) * 0.5 * (np.maximum(ST[:60_000] - 100.0, 0.0)
                                  + np.maximum(ST[60_000:] - 100.0, 0.0))
    assert abs(pay.mean() - float(cos)) < \
        4 * pay.std() / np.sqrt(len(pay)) + 1e-3
