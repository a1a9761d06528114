"""Port vs reference: the scan engine of ``mc_fused`` and what stands on it.

The reference draws inside ``lax.scan`` from ``jax.random`` keys; the port
draws from a ``torch.Generator`` and hands the draws to deterministic
cores. Here the cores are fed the reference's own draws — its
``fold_in``/``split``/``normal``/``poisson``/``gamma``/``uniform`` calls on
the same key, in a Python loop in place of the scan — and held to the
reference in float64:

* ``_fused_paths`` for every ``model_kind`` (gbm, lv_euler, lv_milstein
  on an analytic σ(S, t) written in both packages, heston, heston_qe,
  sabr_ln, sabr_cev, merton, vg, nig), with the geometric-Asian CV,
  dividends and an odd step count: the sums of the payoffs and terminal
  spots at rtol 1e-12; its GBM Greek observables likewise;
* ``_cev_exact_sumstats`` (ν = 0 and ν > 0): the six sums at rtol 1e-12;
* the routes: ``exotic_price_mc(backend="xla")`` (price and stderr at
  rtol 1e-12), ``exotic_greeks_mc`` on the scan (every GBM Greek) and the
  pathwise-AD Greeks ``_ad_exotic_greeks`` (heston, sabr, merton, vg,
  local vol) at rtol 1e-10 per Greek, with the reference's keys;
* the float64 QMC route, which is deterministic: rtol 1e-12 against
  ``exotic_price_mc(backend="qmc", dtype="float64")``;
* the Dupire closure on the scan (``exotic_price_mc_dupire(backend=
  "xla")``): rtol 1e-9, the f64 ∂w/∂T quotient of σ_loc turning an ulp of
  w into ~1e-12 of σ;
* the XLA goldens ``exotic_*_xla_*`` met statistically on the scan, within
  4·hypot(se, se_golden);
* ``levy._standard_gamma``: its scalar-shape draws bit for bit as before
  (SHA-256 recorded from the scalar-only sampler), its
  per-entry form statistically, and the implicit-reparameterisation
  derivative against JAX's ``random_gamma_grad`` at rtol 1e-12.
"""
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax.special import random_gamma_grad

import optpricer_tpu as jp
from optpricer_tpu.models import mc_fused as jmf
import optpricer_tpu_torch as tp
from optpricer_tpu_torch.models import levy as tlevy
from optpricer_tpu_torch.models import mc_fused as tmf
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
F64 = jnp.float64
MARKET = (100.0, 100.0, 1.0, 0.03, 0.01)          # S0, K, T, r, q
HESTON = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
SABR_LN = dict(alpha0=0.25, beta=1.0, nu=0.5, rho=-0.4)
SABR_CEV = dict(alpha0=2.0, beta=0.5, nu=0.4, rho=-0.3)
MERTON = dict(sigma=0.2, lam=0.8, mJ=-0.1, sJ=0.15)
VG = dict(sigma=0.2, theta=-0.14, nu=0.2)
NIG = dict(alpha=8.0, beta=-4.0, delta=0.4)
SV = ("heston", "heston_qe", "sabr_ln", "sabr_cev")


def _sig_jax(S, t):
    return 0.15 + 0.05 * jnp.exp(-t) + 0.1 * jnp.tanh(jnp.log(S / 100.0))


def _sig_torch(S, t):
    return 0.15 + 0.05 * torch.exp(-t) + 0.1 * torch.tanh(torch.log(S / 100.0))


def _ref_draws(key, model_kind, n, jfixed, n_steps, with_grad=False):
    """``draws(k)`` with the reference scan body's draws for step k (and,
    for VG under ``with_grad``, the gamma clock's ∂G/∂shape)."""
    dt = jfixed["T"] / n_steps

    def normal(k):
        return jax.random.normal(k, (n,), F64)

    def step(k):
        zk = jax.random.fold_in(key, k)
        if model_kind in SV:
            k2, kp = jax.random.split(zk)
            return normal(k2), normal(kp)
        if model_kind == "merton":
            kz, kn, kj = jax.random.split(zk, 3)
            counts = jax.random.poisson(kn, jfixed["m_lam"] * dt,
                                        (n,)).astype(F64)
            return normal(kz), counts, normal(kj)
        if model_kind in ("vg", "nig"):
            kc, kz = jax.random.split(zk)
            if model_kind == "vg":
                a = dt / jfixed["v_nu"]
                G = jax.random.gamma(kc, a, (n,), F64)
                dG = random_gamma_grad(a, G) if with_grad else None
                return G, dG, normal(kz)
            k_n, k_u = jax.random.split(kc)
            return normal(k_n), jax.random.uniform(k_u, (n,), F64), \
                normal(kz)
        return (normal(zk),)

    return lambda k: tuple(None if x is None else torch.from_numpy(
        np.array(x)) for x in step(k))


def _fixed_pair(**kw):
    """The port's ``fixed`` dict and the reference's, same numbers."""
    dividends = kw.pop("dividends", None)
    tf = tmf._fixed(torch.float64, "cpu", **kw)
    jf = {k: jnp.asarray(float(v), F64) for k, v in tf.items()}
    if dividends:
        from optpricer_tpu.models.pde import _div_schedule

        jf["div_amts"] = _div_schedule(dividends, kw["T"], N_STEPS, F64)
        tf["div_amts"] = torch.from_numpy(np.array(jf["div_amts"]))
    return tf, jf


N_STEPS, N_PATHS = 8, 1500
S0, K, T, r, q = MARKET

CORE_CASES = {
    # id: (model_kind, payoff, fixed kwargs, static kwargs)
    "gbm-asian-geo": ("gbm", "asian", dict(sigma=0.2), dict(with_geo=True)),
    "gbm-barrier-down-in": ("gbm", "barrier",
                            dict(sigma=0.25, barrier=90.0, rebate=1.5),
                            dict(barrier_type="down-and-in")),
    "gbm-lookback-floating-put": ("gbm", "lookback", dict(sigma=0.2),
                                  dict(strike_type="floating", kind="put")),
    "gbm-digital-odd-steps": ("gbm", "digital", dict(sigma=0.2, payout=2.0),
                              dict(n_steps=7)),
    "gbm-dividends": ("gbm", "vanilla",
                      dict(sigma=0.2, dividends=[(0.3, 1.0), (0.8, 1.5)]),
                      {}),
    "lv_euler-asian": ("lv_euler", "asian", {}, {}),
    "lv_milstein-barrier": ("lv_milstein", "barrier",
                            dict(barrier=125.0, bump=0.01), {}),
    "heston-vanilla": ("heston", "vanilla", dict(heston=HESTON), {}),
    "heston_qe-barrier": ("heston_qe", "barrier",
                          dict(heston=HESTON, barrier=130.0), {}),
    "sabr_ln-vanilla-put": ("sabr_ln", "vanilla", dict(sabr=SABR_LN),
                            dict(kind="put")),
    "sabr_cev-lookback": ("sabr_cev", "lookback", dict(sabr=SABR_CEV), {}),
    "merton-asian-geometric": ("merton", "asian",
                               dict(sigma=0.2, merton=MERTON),
                               dict(average_type="geometric")),
    "vg-vanilla": ("vg", "vanilla", dict(vg=VG), {}),
    "nig-barrier": ("nig", "barrier", dict(nig=NIG, barrier=120.0), {}),
}


def _static(model_kind, payoff, st):
    st = dict(st)
    kw = dict(payoff=payoff, kind=st.pop("kind", "call"),
              n_steps=st.pop("n_steps", N_STEPS), n_paths=N_PATHS,
              antithetic=True,
              barrier_type=st.pop("barrier_type", "up-and-out"),
              average_type=st.pop("average_type", "arithmetic"),
              strike_type=st.pop("strike_type", "fixed"),
              model_kind=model_kind)
    kw.update(st)
    return kw


def _sums(*arrays):
    out = []
    for a in arrays:
        a = np.asarray(a, np.float64)
        out += [a.sum(), (a * a).sum()]
    a, b = (np.asarray(x, np.float64) for x in arrays[:2])
    return np.array(out + [(a * b).sum()])


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_scan_core_fed_reference_draws(case):
    model_kind, payoff, fk, st = CORE_CASES[case]
    tf, jf = _fixed_pair(S0=S0, K=K, T=T, r=r, q=q, **fk)
    kw = _static(model_kind, payoff, st)
    lv = model_kind.startswith("lv")
    key = jax.random.key(11)
    ref = jmf._fused_paths(key, jf, sigma_loc=_sig_jax if lv else None,
                           dtype=F64, **kw)
    got = tmf._fused_paths(
        _ref_draws(key, model_kind, N_PATHS, jf, kw["n_steps"]), tf,
        sigma_loc=_sig_torch if lv else None, dtype=torch.float64, **kw)
    assert len(got) == len(ref)
    np.testing.assert_allclose(_sums(*(g.numpy() for g in got)),
                               _sums(*(np.asarray(x) for x in ref)),
                               rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("payoff, st", [
    ("vanilla", {}), ("asian", {}),
    ("asian", dict(average_type="geometric", strike_type="floating")),
    ("lookback", dict(kind="put", strike_type="floating")),
    ("lookback", {}), ("barrier", {}), ("digital", dict(kind="put"))],
    ids=["vanilla", "asian", "asian-geo-floating", "lookback-floating-put",
         "lookback", "barrier", "digital-put"])
def test_scan_greek_observables_fed_reference_draws(payoff, st):
    tf, jf = _fixed_pair(S0=S0, K=K, T=T, r=r, q=q, sigma=0.25,
                         barrier=125.0, payout=1.0)
    kw = _static("gbm", payoff, st)
    key = jax.random.key(5)
    ref = jmf._fused_paths(key, jf, sigma_loc=None, dtype=F64,
                           with_greeks=True, **kw)
    got = tmf._fused_paths(_ref_draws(key, "gbm", N_PATHS, jf, N_STEPS), tf,
                           sigma_loc=None, dtype=torch.float64,
                           with_greeks=True, **kw)
    np.testing.assert_allclose(_sums(got[0].numpy(), got[1].numpy()),
                               _sums(np.asarray(ref[0]), np.asarray(ref[1])),
                               rtol=1e-12, atol=0.0)
    assert len(got[2]) == len(ref[2])
    for g, j in zip(got[2], ref[2]):
        g, j = g.numpy(), np.asarray(j)
        np.testing.assert_allclose([g.sum(), (g * g).sum()],
                                   [j.sum(), (j * j).sum()], rtol=1e-12,
                                   atol=1e-12 * np.abs(j).sum())


class _RefCevDraws:
    """The reference exact-CEV scan's draws: per step the keys
    split(fold_in(key, k), 3) = (kp, kg, ka)."""

    def __init__(self, key, n):
        self.key, self.n = key, n

    def _keys(self, k):
        return jax.random.split(jax.random.fold_in(self.key, k), 3)

    def normal(self, k):
        return torch.from_numpy(np.array(jax.random.normal(
            self._keys(k)[2], (self.n,), F64)))

    def poisson(self, k, rate):
        return torch.from_numpy(np.array(jax.random.poisson(
            self._keys(k)[0], jnp.asarray(rate.numpy())).astype(F64)))

    def gamma(self, k, shape):
        return torch.from_numpy(np.array(jax.random.gamma(
            self._keys(k)[1], jnp.asarray(shape.numpy()), dtype=F64)))


@pytest.mark.parametrize("payoff, sabr, barrier_type", [
    ("vanilla", dict(alpha0=2.0, beta=0.5, nu=0.0, rho=0.0), "up-and-out"),
    ("digital", dict(alpha0=1.2, beta=0.7, nu=0.0, rho=0.0), "up-and-out"),
    ("barrier", dict(alpha0=2.0, beta=0.5, nu=0.0, rho=0.0), "up-and-out"),
    ("vanilla", dict(alpha0=2.0, beta=0.5, nu=0.4, rho=-0.3), "up-and-out"),
], ids=["vanilla", "digital", "barrier", "vanilla-vol"])
def test_exact_cev_core_fed_reference_draws(payoff, sabr, barrier_type):
    vals = dict(S0=S0, K=K, T=T, r=r, q=q, barrier=130.0, payout=1.0,
                s_beta=sabr["beta"], s_alpha0=sabr["alpha0"],
                s_nu=sabr["nu"], s_rho=sabr["rho"])
    jf = {k: jnp.asarray(v, F64) for k, v in vals.items()}
    tf = {k: torch.tensor(v, dtype=torch.float64) for k, v in vals.items()}
    kw = dict(payoff=payoff, n_steps=6, n_paths=N_PATHS,
              barrier_up=barrier_type.startswith("up"),
              knock_in=barrier_type.endswith("in"),
              has_vol=sabr["nu"] > 0.0)
    key = jax.random.key(3)
    ref = np.asarray(jmf._cev_exact_sumstats(key, jf, dtype=F64, **kw))
    got = tmf._cev_exact_sumstats(_RefCevDraws(key, N_PATHS), tf,
                                  dtype=torch.float64, **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


def _patch_draws(monkeypatch, seed, jf_of):
    """Route the port's scan draw step to the reference's draws on
    ``jax.random.key(seed)``, as the reference's one-device scan keys
    them."""
    def draws(gen, model_kind, n_paths, *, T, n_steps, dtype, device,
              m_lam=0.0, v_nu=1.0, with_grad=False):
        return _ref_draws(jax.random.key(seed), model_kind, n_paths,
                          jf_of(m_lam, v_nu, T), n_steps, with_grad)

    monkeypatch.setattr(tmf, "_scan_draws", draws)


def _jf(m_lam, v_nu, T_):
    return dict(T=jnp.asarray(T_, F64), m_lam=jnp.asarray(m_lam, F64),
                v_nu=jnp.asarray(v_nu, F64))


ROUTE_CASES = {
    "asian-geo-cv": ("asian", dict(sigma=0.2, control_variate=True)),
    "merton": ("vanilla", dict(merton=MERTON)),
    "vg": ("asian", dict(vg=VG)),
    "nig": ("vanilla", dict(nig=NIG, kind="put")),
    "dividends": ("vanilla", dict(sigma=0.2, dividends=[(0.5, 2.0)])),
    "odd-steps": ("lookback", dict(sigma=0.2, n_steps=7)),
    "heston": ("barrier", dict(heston=HESTON, barrier=130.0)),
    "sabr_cev-float64": ("vanilla", dict(sabr=SABR_CEV, dtype="float64")),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_scan_route_fed_reference_draws(monkeypatch, case):
    payoff, kw = ROUTE_CASES[case]
    kw = dict(dict(n_steps=N_STEPS, n_paths=N_PATHS, seed=21), **kw)
    ref = jp.exotic_price_mc(payoff, *MARKET, backend="xla", **kw)
    _patch_draws(monkeypatch, 21, _jf)
    got = tp.exotic_price_mc(payoff, *MARKET, backend="xla", device="cpu",
                             **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


def test_lv_closure_route_fed_reference_draws(monkeypatch):
    kw = dict(n_steps=N_STEPS, n_paths=N_PATHS, seed=8, scheme="milstein")
    ref = jp.exotic_price_mc("asian", *MARKET, sigma_loc=_sig_jax, **kw)
    _patch_draws(monkeypatch, 8, _jf)
    got = tp.exotic_price_mc("asian", *MARKET, sigma_loc=_sig_torch,
                             device="cpu", **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("payoff, kw", [
    ("vanilla", {}), ("asian", dict(average_type="geometric")),
    ("lookback", dict(strike_type="floating")),
    ("barrier", dict(barrier=120.0)), ("digital", dict(kind="put"))])
def test_gbm_scan_greeks_fed_reference_draws(monkeypatch, payoff, kw):
    kw = dict(sigma=0.2, n_steps=N_STEPS, n_paths=N_PATHS, seed=13, **kw)
    ref = jp.exotic_greeks_mc(payoff, *MARKET, backend="xla", **kw)
    _patch_draws(monkeypatch, 13, _jf)
    got = tp.exotic_greeks_mc(payoff, *MARKET, backend="xla", device="cpu",
                              **kw)
    assert set(got) == set(ref)
    for name, value in ref.items():
        assert got[name] == pytest.approx(value, rel=1e-10, abs=1e-13), name


AD_CASES = {
    "heston": dict(heston=HESTON),
    "sabr_ln": dict(sabr=SABR_LN),
    "sabr_cev": dict(sabr=SABR_CEV),
    "merton": dict(merton=MERTON),
    "vg": dict(vg=VG),
    "local-vol": dict(sigma_loc=None),
}


@pytest.mark.parametrize("case", list(AD_CASES))
def test_ad_greeks_fed_reference_draws(monkeypatch, case):
    dyn = dict(AD_CASES[case])
    payoff = "asian" if case in ("merton", "vg") else "vanilla"
    kw = dict(n_steps=N_STEPS, n_paths=1000, seed=17)
    j_dyn, t_dyn = dict(dyn), dict(dyn)
    if "sigma_loc" in dyn:
        j_dyn["sigma_loc"], t_dyn["sigma_loc"] = _sig_jax, _sig_torch
    ref = jp.exotic_greeks_mc(payoff, *MARKET, **j_dyn, **kw)
    _patch_draws(monkeypatch, 17, _jf)
    got = tp.exotic_greeks_mc(payoff, *MARKET, device="cpu", **t_dyn, **kw)
    assert set(got) == set(ref)
    for name, value in ref.items():
        assert got[name] == pytest.approx(value, rel=1e-10, abs=1e-13), name
    if case == "merton":   # λ is not differentiable pathwise
        assert not any("lam" in name for name in got)


@pytest.mark.parametrize("payoff, kw", [
    ("asian", {}), ("barrier", dict(barrier=120.0)),
    ("lookback", dict(strike_type="floating", kind="put")),
    ("digital", dict(payout=2.0))])
def test_qmc_float64_route_matches_reference(payoff, kw):
    kw = dict(sigma=0.2, n_paths=2048, n_steps=16, seed=7, dtype="float64",
              backend="qmc", **kw)
    ref = jp.exotic_price_mc(payoff, *MARKET, **kw)
    got = tp.exotic_price_mc(payoff, *MARKET, device="cpu", **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


def test_dupire_scan_route_matches_reference(monkeypatch):
    from optpricer_tpu.models import calibration as jcal
    from optpricer_tpu_torch import convert

    fwd = {Tx: 100.0 * np.exp(0.03 * Tx) for Tx in (0.25, 0.5, 1.0)}
    strikes = {Tx: np.linspace(0.75, 1.25, 21) * F for Tx, F in fwd.items()}
    ivs = {Tx: 0.2 + 0.05 * np.log(strikes[Tx] / F) ** 2
           - 0.02 * np.log(strikes[Tx] / F) for Tx, F in fwd.items()}
    ref_s = jcal.fit_svi_surface(strikes, fwd, ivs)
    kw = dict(n_steps=7, n_paths=N_PATHS, seed=2, control_variate=False)
    ref = jp.exotic_price_mc_dupire("vanilla", ref_s, 100.0, 100.0, 1.0,
                                    0.03, 0.0, backend="xla", **kw)
    _patch_draws(monkeypatch, 2, _jf)
    got = tp.exotic_price_mc_dupire("vanilla", convert.vol_surface(ref_s),
                                    100.0, 100.0, 1.0, 0.03, 0.0,
                                    backend="xla", device="cpu", **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("name, payoff, kw", [
    ("exotic_asian_xla_seed3", "asian", dict(sigma=0.2, seed=3)),
    ("exotic_barrier_heston_xla_seed5", "barrier",
     dict(seed=5, barrier=135.0,
          heston=dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6))),
    ("exotic_sabr_xla_seed9", "vanilla",
     dict(seed=9, sabr=dict(alpha0=0.25, beta=1.0, nu=0.5, rho=-0.4))),
])
def test_xla_goldens_met_statistically_on_scan(name, payoff, kw):
    """The goldens of the reference's scan, met by the port's scan on its
    own draws: the same estimator design, so the stderrs agree to a few
    per cent (within 10 %)."""
    golden = GOLDENS[name]
    px, se = tp.exotic_price_mc(payoff, 100.0, 100.0, 1.0, 0.03,
                                n_steps=32, n_paths=50_000, backend="xla",
                                dtype="float64", device="cpu", **kw)
    assert abs(px - golden["price"]) <= 4.0 * np.hypot(se, golden["stderr"])
    assert se == pytest.approx(golden["stderr"], rel=0.1)


# ---------------------------------------------------------------------------
# levy._standard_gamma with per-entry shapes, and its reparameterisation
# ---------------------------------------------------------------------------
SCALAR_GAMMA_SHA = {   # recorded from the scalar-only sampler
    (0.3, torch.float64): (
        "9f25fb13bf88635d028d05480c89774d25f4be4718807ad9db214016f62e6ca9",
        0.4931087681705435),
    (2.5, torch.float64): (
        "a35d70b8d6728cbe421d7e62a7df20eeae2905169d8ceb4fd91444828de516fb",
        0.5376914310928181),
    (0.02, torch.float32): (
        "5b9c45aa2c5c85e9b2b3635cc39d38efdb4d9b48ebc382255507da733559912b",
        0.7194480904473233),
    (1.0, torch.float32): (
        "a7764372e71e29e18fbf6ae1fd269962864d369c4d626f6b1526c00c8569d683",
        0.039498056078127175),
}


@pytest.mark.parametrize("a, dtype", list(SCALAR_GAMMA_SHA))
def test_scalar_gamma_draws_unchanged(a, dtype):
    gen = torch.Generator().manual_seed(1234)
    x = tlevy._standard_gamma(gen, a, (3, 257), dtype, "cpu")
    after = torch.rand(1, generator=gen, dtype=torch.float64).item()
    assert (hashlib.sha256(x.numpy().tobytes()).hexdigest(), after) == \
        SCALAR_GAMMA_SHA[(a, dtype)]


def test_per_entry_gamma_shapes():
    """Shapes below and above 1 in one call: each group's mean and
    variance within 5 standard errors of a."""
    n = 40_000
    a = torch.cat([torch.full((n,), 0.05), torch.full((n,), 0.7),
                   torch.full((n,), 3.5), torch.full((n,), 40.0)]).double()
    gen = torch.Generator().manual_seed(9)
    x = tlevy._standard_gamma(gen, a, (4 * n,), torch.float64, "cpu")
    assert x.shape == (4 * n,) and bool(torch.all(x >= 0.0))
    for i, shape in enumerate((0.05, 0.7, 3.5, 40.0)):
        xs = x[i * n:(i + 1) * n]
        se = np.sqrt(shape / n)
        assert abs(float(xs.mean()) - shape) < 5.0 * se, shape
        # Var = a, with the stderr of the sample variance ≈ a·√(2/n)·√(1+3/a)
        assert abs(float(xs.var()) - shape) < \
            5.0 * shape * np.sqrt((2.0 + 6.0 / shape) / n), shape


def test_gamma_sample_grad_matches_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(0.005, 5.0, 3000),
                        rng.uniform(0.01, 20.0, 3000), [0.5]])
    x = np.concatenate([rng.gamma(a[:3000]), rng.uniform(0.0, 30.0, 3000),
                        [0.0]])
    ref = np.asarray(random_gamma_grad(a, x))
    got = tlevy._gamma_sample_grad(torch.tensor(a), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("lam", [0.0, 0.3, 4.0, 9.99, 10.0, 55.0, 3200.0])
def test_poisson_sampler_moments(lam):
    """The exact CEV scan's Poisson draws (Knuth below 10, PTRS from 10):
    mean and variance within 5 standard errors of λ, zero at λ = 0,
    integers everywhere."""
    n = 100_000
    x = tmf._poisson(torch.Generator().manual_seed(2),
                     torch.full((n,), lam, dtype=torch.float64))
    assert torch.equal(x, torch.floor(x)) and bool(torch.all(x >= 0.0))
    if lam == 0.0:
        assert not bool(x.any())
        return
    assert abs(float(x.mean()) - lam) < 5.0 * np.sqrt(lam / n)
    assert abs(float(x.var()) - lam) < \
        5.0 * lam * np.sqrt((2.0 + 1.0 / lam) / n)
