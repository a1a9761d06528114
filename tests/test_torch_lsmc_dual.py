"""Port vs reference: the three Andersen-Broadie dual upper bounds.

Each dual's deterministic core is fed the reference's own draws — its
``split`` of the key into the outer and inner streams, the outer normals
as one ``normal`` call, each inner (k, j) block from ``fold_in(fold_in(
key_inner, k), j)`` — through a draw object with the port's interface
(``outer(k)``, ``inner(k, j)``), and held to the reference's jitted dual
on the same policy in float64 at rtol 1e-10: GBM with its Black-Scholes
optional-stopping control variate, Heston with the per-sample COS control
variate (and with it switched off, ``_SV_INNER_CV``), LSV under both
schemes with the Black-budget control variate (and without,
``_LSV_INNER_CV``). The end-to-end brackets at tests/test_lsmc.py's sizes:
the GBM Bermudan-16 lattice (the port's ``crr``) inside [lower − 3 se,
upper + 3 se] and the LSV bracket around the recorded ADI Bermudan-9
(``chip_smoke.HESTON_ADI``). The Heston bracket at its test size (2·32 x
1 024 COS evaluations of 64 terms a date) runs on the card, in
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from optpricer_tpu.models import american_mc as jam
from optpricer_tpu.models import lsv as jlsv
from optpricer_tpu.models import processes as jpr
import optpricer_tpu_torch as tp
from optpricer_tpu_torch.models import american_mc as tam
from tests.torch_threads import torch_one_thread  # noqa: F401

F64 = jnp.float64
HP = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
N_STEPS, N_INNER, N_OUTER = 5, 8, 48


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f64(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float64)


class _RefDraws:
    """The reference dual's draws under the port's draw interface."""

    def __init__(self, key, width: int, n_outer: int = N_OUTER):
        key_paths, self.key_inner = jax.random.split(key)
        lead = () if width == 1 else (width,)
        shape = (N_STEPS,) + lead + (n_outer,)
        self.z = jax.random.normal(key_paths, shape, F64)
        self.inner_shape = lead + (N_INNER // 2, n_outer)

    def outer(self, k):
        return _t(self.z[k - 1])

    def inner(self, k, j):
        kj = jax.random.fold_in(jax.random.fold_in(self.key_inner, k), j)
        return _t(jax.random.normal(kj, self.inner_shape, F64))


def _close(got, want, what):
    for g, w, name in zip(got, want, ("upper", "se")):
        g, w = float(g), float(w)
        assert abs(g - w) <= 1e-10 * abs(w), f"{what} {name}: {g!r} vs {w!r}"


STATIC = dict(n_inner=N_INNER, n_steps=N_STEPS, n_paths=N_OUTER)


@pytest.mark.parametrize("kind,K,q", [("put", 110.0, 0.0),
                                      ("call", 95.0, 0.07)])
def test_gbm_dual_matches_reference(kind, K, q):
    is_call = kind == "call"
    paths = jpr.gbm_paths(100.0, 0.05, q, 0.25, 1.0, N_STEPS, 2048, seed=3,
                          dtype=F64)
    betas = jam._lsmc_backward_betas(
        paths, jnp.asarray(K, F64), jnp.asarray(0.05, F64),
        jnp.asarray(1.0 / N_STEPS, F64), jnp.asarray(is_call), basis_dim=4)
    key = jax.random.key(11)
    mkt = (100.0, K, 1.0, 0.05, q, 0.25)
    want = jam._lsmc_dual_upper(key, betas, *(jnp.asarray(x, F64)
                                              for x in mkt),
                                jnp.asarray(is_call), basis_dim=4, **STATIC)
    got = tam._lsmc_dual_upper(_RefDraws(key, 1), _t(betas),
                               *(_f64(x) for x in mkt), np.bool_(is_call),
                               basis_dim=4, **STATIC)
    _close(got, want, "gbm dual")


def _sv_betas(S, v, basis_dim=6):
    return jam._lsmc_backward_sv(
        S, v, jnp.asarray(110.0, F64), jnp.asarray(0.05, F64),
        jnp.asarray(1.0 / N_STEPS, F64), jnp.asarray(False),
        basis_dim=basis_dim, two_pass=True)


@pytest.mark.parametrize("with_cv", [True, False])
def test_heston_dual_matches_reference(with_cv, monkeypatch):
    monkeypatch.setattr(jam, "_SV_INNER_CV", with_cv)
    monkeypatch.setattr(tam, "_SV_INNER_CV", with_cv)
    S, v = jpr.heston_paths(100.0, 0.05, 0.0, *HP.values(), 1.0, N_STEPS,
                            2048, seed=2, return_variance=True, dtype=F64,
                            scheme="qe")
    betas = _sv_betas(S, v)
    key = jax.random.key(9)
    heston = [HP[k] for k in ("v0", "kappa", "theta", "xi", "rho")]
    tail = (110.0, 1.0, 0.05, 0.0)
    # the switch is read when the reference traces: a shape of its own
    # for each setting
    static = dict(STATIC, n_paths=N_OUTER - (0 if with_cv else 2))
    draws = _RefDraws(key, 2, static["n_paths"])
    want = jam._lsmc_dual_upper_sv(
        key, betas, jnp.asarray(100.0, F64),
        *(jnp.asarray(x, F64) for x in heston + list(tail)),
        jnp.asarray(False), basis_dim=6, **static)
    got = tam._lsmc_dual_upper_sv(
        draws, _t(betas), _f64(100.0), *(_f64(x) for x in heston),
        *(_f64(x) for x in tail), np.bool_(False), basis_dim=6, **static)
    _close(got, want, "heston dual")


def _lsv_models(scheme):
    lev = np.exp(0.1 * np.sin(np.arange(8 * 9).reshape(8, 9)))
    kw = dict(S0=100.0, r=0.05, q=0.0, T=8 / 5, **HP, scheme=scheme)
    return (jlsv.LSVModel(**kw, x_bins=jnp.linspace(-1.0, 1.0, 9),
                          leverage=jnp.asarray(lev)),
            tp.LSVModel(**kw, x_bins=torch.linspace(-1.0, 1.0, 9,
                                                    dtype=torch.float64),
                        leverage=torch.tensor(lev)))


@pytest.mark.parametrize("scheme,with_cv", [("euler", True), ("qe", True),
                                            ("qe", False)])
def test_lsv_dual_matches_reference(scheme, with_cv, monkeypatch):
    """A table of 8 rows priced over its first 5 (n_use < n_steps)."""
    monkeypatch.setattr(jam, "_LSV_INNER_CV", with_cv)
    monkeypatch.setattr(tam, "_LSV_INNER_CV", with_cv)
    jmodel, tmodel = _lsv_models(scheme)
    S, v = jlsv.lsv_path_matrix(jmodel, n_paths=2048, T=1.0, seed=3,
                                dtype=F64)
    betas = _sv_betas(S, v)
    key = jax.random.key(4)
    static = dict(STATIC, n_paths=N_OUTER - (0 if with_cv else 2))
    draws = _RefDraws(key, 2, static["n_paths"])
    want = jam._lsmc_dual_upper_lsv(key, betas, jmodel,
                                    jnp.asarray(110.0, F64),
                                    jnp.asarray(False), basis_dim=6,
                                    **static)
    got = tam._lsmc_dual_upper_lsv(draws, _t(betas), tmodel, _f64(110.0),
                                   np.bool_(False), basis_dim=6, **static)
    _close(got, want, f"lsv {scheme} dual")


def test_dual_draws_keyed_by_dates():
    """The port's draw step: outer date k from (seed, *prefix, 0, k), the
    inner block (k, j) from (seed, *prefix, 1, k, j), whatever the order
    they are asked for in."""
    from optpricer_tpu_torch.models.monte_carlo import keyed_generator

    d = tam._DualDraws(7, (0xAB,), 16, 4, 2, torch.float64, "cpu")
    late, early = d.inner(3, 5), d.inner(1, 2)
    assert late.shape == (2, 4, 16) and d.outer(2).shape == (2, 16)
    want = torch.randn((2, 4, 16), dtype=torch.float64,
                       generator=keyed_generator(7, (0xAB, 1, 1, 2), "cpu"))
    assert torch.equal(early, want)
    assert torch.equal(d.inner(3, 5), late)
    assert not torch.equal(d.inner(3, 4), late)


# -- end to end: tests/test_lsmc.py's brackets on the port ---------------
def test_gbm_lattice_inside_bracket():
    opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.25)
    ref_b16 = tp.crr(opt, "put", N=4000, device="cpu",
                     exercise_dates=[j / 16 for j in range(1, 16)])
    ref_am = tp.crr(opt, "put", N=4000, american=True, device="cpu")
    br = tp.lsmc_price(opt, "put", n_paths=50_000, n_steps=16, seed=0,
                       bound="both", n_inner=128, n_upper_paths=2_000,
                       dtype="float64", device="cpu")
    lo, lo_se = br["lower"]
    up, up_se = br["upper"]
    assert lo - 3 * lo_se < ref_b16 < up + 3 * up_se, (lo, ref_b16, up)
    assert br["gap"] >= -3 * (lo_se + up_se)
    assert br["gap"] < 0.005 * ref_b16
    assert up + 3 * up_se < ref_am
    assert lo - 3 * lo_se < ref_am


def test_lsv_bracket_contains_recorded_adi():
    model = tp.LSVModel(S0=100.0, r=0.05, q=0.0, T=1.0, **HP,
                        x_bins=torch.linspace(-1.0, 1.0, 9),
                        leverage=torch.ones((9, 9)), scheme="qe")
    ref = chip_smoke.HESTON_ADI["bermudan9_lsv"]
    ref_amer = chip_smoke.HESTON_ADI["american"]
    opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.2)
    br = tp.lsmc_price(opt, "put", lsv=model, n_paths=20_000, seed=2,
                       bound="both", n_inner=64, n_upper_paths=1_024,
                       device="cpu")
    lo, lo_se = br["lower"]
    up, up_se = br["upper"]
    assert lo - 3 * lo_se <= ref <= up + 2 * up_se, (lo, ref, up)
    assert lo - 2 * lo_se <= ref_amer
    assert br["gap"] >= -(lo_se + up_se)
    assert br["gap"] < 0.05 * ref
