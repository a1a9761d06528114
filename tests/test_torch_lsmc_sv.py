"""Port vs reference: the stochastic-vol Longstaff-Schwartz passes
(Heston and LSV), the Lévy routes, the mesh route, and the recorded ADI
values that stand in for the Heston PDE until it is ported.

* ``_sv_basis``, ``_lsmc_backward_sv`` (American, Bermudan, the betas of
  the two-pass fit, basis 6 and 7) and ``_lsmc_forward_fixed_policy_sv``
  fed the reference's own QE and LSV path matrices (4 096 antithetic paths
  x 16 dates, float64): price and stderr at rtol 1e-10, betas at 1e-9.
* ``_lsmc_sharded_core``, fed each shard's path matrix from the
  reference's ``_gbm_core`` / ``_heston_qe_core`` on ``fold_in(key,
  shard)``, against the reference's ``lsmc_price_sharded`` on the 8-device
  CPU mesh at rtol 1e-10; the port's own sharded call on ``get_mesh(
  devices=["cpu"] * 8)`` within 5·hypot(se, se) of its one-device call
  (GBM) and within tests/test_lsmc.py's band (Heston).
* The Heston, LSV and Lévy end-to-end calls at tests/test_lsmc.py's and
  tests/test_levy.py's sizes, oracles and tolerances. The Heston oracle is
  the reference's ADI PDE (``heston_fd_price``), which the port does not
  have yet: ``chip_smoke.HESTON_ADI`` records its values, and
  :func:`test_recorded_adi_values` recomputes each with the reference to
  1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import optpricer_tpu as jp
from optpricer_tpu.models import american_mc as jam
from optpricer_tpu.models import lsv as jlsv
from optpricer_tpu.models import processes as jpr
import optpricer_tpu_torch as tp
from optpricer_tpu_torch.models import american_mc as tam
from optpricer_tpu_torch.parallel import get_mesh
from tests.torch_threads import torch_one_thread  # noqa: F401

F64 = jnp.float64
N_STEPS, N_PATHS = 16, 2048
HP = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
OPT = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f64(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float64)


def _close(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), f"{what}: {got!r} vs {want!r}"


def _args(K, n_steps, is_call=False, r=0.05):
    return ((jnp.asarray(K, F64), jnp.asarray(r, F64),
             jnp.asarray(1.0 / n_steps, F64), jnp.asarray(is_call)),
            (_f64(K), _f64(r), _f64(1.0 / n_steps), np.bool_(is_call)))


def _qe(seed):
    return jpr.heston_paths(100.0, 0.05, 0.0, *HP.values(), 1.0, N_STEPS,
                            N_PATHS, seed=seed, return_variance=True,
                            dtype=F64, scheme="qe")


def _lsv_pair(scheme, n_steps=N_STEPS):
    """The same LSV model in both packages: a smooth non-flat leverage."""
    lev = np.exp(0.1 * np.sin(np.arange(n_steps * 9).reshape(n_steps, 9)))
    kw = dict(S0=100.0, r=0.05, q=0.0, T=1.0, **HP, scheme=scheme)
    return (jlsv.LSVModel(**kw, x_bins=jnp.linspace(-1.0, 1.0, 9),
                          leverage=jnp.asarray(lev)),
            tp.LSVModel(**kw, x_bins=torch.linspace(-1.0, 1.0, 9,
                                                    dtype=torch.float64),
                        leverage=torch.tensor(lev)))


def _sv_paths(source, seed):
    if source == "qe":
        return _qe(seed)
    model, _ = _lsv_pair(source.removeprefix("lsv-"))
    return jlsv.lsv_path_matrix(model, n_paths=N_PATHS, seed=seed,
                                dtype=F64)


def test_sv_basis_matches_reference():
    S, v = _qe(1)
    for k in (3, 6, 7):
        np.testing.assert_allclose(
            tam._sv_basis(_t(S), _t(v), _f64(110.0), k).numpy(),
            np.array(jam._sv_basis(S, v, jnp.asarray(110.0, F64), k)),
            rtol=1e-15)


@pytest.mark.parametrize("source", ["qe", "lsv-euler", "lsv-qe"])
@pytest.mark.parametrize("basis_dim", [6, 7])
def test_sv_passes_match_reference(source, basis_dim):
    S, v = _sv_paths(source, 2)
    S2, v2 = _sv_paths(source, 3)
    aj, at = _args(110.0, N_STEPS)
    bj = jam._lsmc_backward_sv(S, v, *aj, basis_dim=basis_dim,
                               two_pass=True)
    bt = tam._lsmc_backward_sv(_t(S), _t(v), *at, basis_dim=basis_dim,
                               two_pass=True)
    np.testing.assert_allclose(bt.numpy(), np.array(bj), rtol=1e-9)
    for got, want in (
            (tam._lsmc_backward_sv(_t(S), _t(v), *at, basis_dim=basis_dim),
             jam._lsmc_backward_sv(S, v, *aj, basis_dim=basis_dim)),
            (tam._lsmc_forward_fixed_policy_sv(_t(S2), _t(v2), _t(bj), *at,
                                               basis_dim=basis_dim),
             jam._lsmc_forward_fixed_policy_sv(S2, v2, bj, *aj,
                                               basis_dim=basis_dim))):
        _close(got[0], want[0], 1e-10, "price")
        _close(got[1], want[1], 1e-10, "stderr")


@pytest.mark.parametrize("dates", [[], [0.25, 0.5, 0.75],
                                   [j / 16 for j in range(1, 17)]])
def test_sv_bermudan_matches_reference(dates):
    S, v = _qe(2)
    aj, at = _args(110.0, N_STEPS)
    mask = jam._bermudan_mask(dates, 1.0, N_STEPS)
    pj, sj = jam._lsmc_backward_sv(S, v, *aj, jnp.asarray(mask),
                                   basis_dim=6)
    pt, st = tam._lsmc_backward_sv(_t(S), _t(v), *at,
                                   tam._bermudan_mask(dates, 1.0, N_STEPS),
                                   basis_dim=6)
    _close(pt, pj, 1e-10, "price")
    _close(st, sj, 1e-10, "stderr")


def test_recorded_adi_values():
    """``chip_smoke.HESTON_ADI`` holds the reference ADI prices that the
    Heston and LSV brackets are held to on the card: each recomputed here
    with the reference to 1e-9."""
    from optpricer_tpu import heston_fd_price

    assert set(chip_smoke.HESTON_ADI) == set(chip_smoke.HESTON_ADI_CALLS)
    for name, kw in chip_smoke.HESTON_ADI_CALLS.items():
        ref = float(heston_fd_price(100.0, 110.0, 1.0, 0.05, 0.0, **HP,
                                    kind="put", **kw))
        assert abs(chip_smoke.HESTON_ADI[name] - ref) <= 1e-9, (name, ref)


# -- end to end: tests/test_lsmc.py::TestHestonLsmc on the port ----------
def test_heston_two_pass_brackets_adi():
    ref = chip_smoke.HESTON_ADI["american"]
    lo, se = tp.lsmc_price(OPT, "put", heston=HP, n_paths=100_000,
                           n_steps=50, seed=2, bound="lower", device="cpu")
    assert lo < ref + 4 * se + 5e-3, (lo, ref)
    assert lo > ref - 0.15
    eu = float(tp.heston_price_cos(100.0, 110.0, 1.0, 0.05, 0.0, **HP,
                                   kind="put", device="cpu"))
    assert lo > eu + 0.5


def test_heston_call_and_degenerate_limits():
    eu = float(tp.heston_price_cos(100.0, 100.0, 1.0, 0.05, 0.0, **HP,
                                   kind="call", device="cpu"))
    opt = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    px, se = tp.lsmc_price(opt, "call", heston=HP, n_paths=100_000,
                           n_steps=50, seed=4, device="cpu")
    assert abs(px - eu) < 4 * se + 0.02
    hp0 = dict(v0=0.0625, kappa=1.5, theta=0.0625, xi=1e-6, rho=0.0)
    opt25 = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.25)
    pg, seg = tp.lsmc_price(opt25, "put", n_paths=100_000, n_steps=25,
                            seed=2, device="cpu")
    ph, seh = tp.lsmc_price(opt25, "put", heston=hp0, n_paths=100_000,
                            n_steps=25, seed=2, device="cpu")
    assert abs(ph - pg) < 4 * (seg + seh) + 0.02
    px, se = tp.lsmc_price(OPT, "put", heston=HP, basis_dim=7,
                           n_paths=20_000, n_steps=16, seed=2, device="cpu")
    assert np.isfinite(px) and px > 0 and se > 0


def test_heston_bermudan_limits():
    kw = dict(heston=HP, n_paths=100_000, n_steps=20, seed=4, device="cpu")
    pe, se = tp.lsmc_price(OPT, "put", exercise_dates=[], **kw)
    eu = float(tp.heston_price_cos(100.0, 110.0, 1.0, 0.05, 0.0, **HP,
                                   kind="put", device="cpu"))
    assert abs(pe - eu) < 4.0 * se
    pf, _ = tp.lsmc_price(OPT, "put",
                          exercise_dates=list(np.linspace(0.05, 1.0, 20)),
                          **kw)
    pa, _ = tp.lsmc_price(OPT, "put", **kw)
    assert pf == pa
    pq, _ = tp.lsmc_price(OPT, "put", exercise_dates=[0.25, 0.5, 0.75],
                          **kw)
    assert pe - 2 * se < pq < pa + 2 * se


def test_lsv_bermudan_limits():
    model = tp.LSVModel(S0=100.0, r=0.05, q=0.0, T=1.0, **HP,
                        x_bins=torch.linspace(-1.0, 1.0, 9),
                        leverage=torch.ones((16, 9)))
    kw = dict(lsv=model, n_paths=50_000, seed=4, device="cpu")
    pe, se = tp.lsmc_price(OPT, "put", exercise_dates=[], **kw)
    pq, _ = tp.lsmc_price(OPT, "put", exercise_dates=[0.25, 0.5, 0.75],
                          **kw)
    pf, _ = tp.lsmc_price(OPT, "put",
                          exercise_dates=list(np.linspace(1 / 16, 1.0, 16)),
                          **kw)
    pa, _ = tp.lsmc_price(OPT, "put", **kw)
    assert pe - 2 * se <= pq <= pf + 2 * se
    assert pf == pa


# -- the mesh route ------------------------------------------------------


@pytest.mark.parametrize("heston", [None, HP], ids=["gbm", "heston"])
def test_sharded_core_matches_reference(heston):
    """Each shard fed the reference's own per-device paths: the sharded
    regression and the final sums equal the reference's sharded call."""
    from optpricer_tpu.parallel import get_mesh as jmesh

    n_steps, n_local, seed = 8, 256, 5
    kw = dict(n_paths=8 * 2 * n_local, n_steps=n_steps, seed=seed,
              dtype="float64", heston=heston)
    opt = jp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.05, sigma=0.25)
    pj, sej = jam.lsmc_price_sharded(jmesh(8), opt, "put", **kw)
    key = jax.random.key(seed)
    mkt = [jnp.asarray(v, F64) for v in (100.0, 0.05, 0.0, 0.25, 1.0)]
    shards = []
    for d in range(8):
        local = jax.random.fold_in(key, d)
        if heston is None:
            shards.append((_t(jpr._gbm_core(
                local, *mkt, n_steps=n_steps, n_paths=2 * n_local,
                antithetic=True, dtype=F64)), None))
        else:
            hp = [jnp.asarray(heston[k], F64)
                  for k in ("v0", "kappa", "theta", "xi", "rho")]
            S, v = jpr._heston_qe_core(local, *mkt[:3], *hp, mkt[4],
                                       n_steps=n_steps, n_paths=2 * n_local,
                                       antithetic=True, dtype=F64)
            shards.append((_t(S), _t(v)))
    n, sv, sv2 = tam._lsmc_sharded_core(
        shards, 100.0, 105.0, 0.05, 1.0 / n_steps, np.bool_(False),
        basis_dim=6 if heston else 4, heston=heston is not None)
    mean = sv / n
    se = np.sqrt(max(0.0, (sv2 - n * mean * mean) / (n - 1.0)) / n)
    _close(max(mean, 5.0), pj, 1e-10, "price")
    _close(se, sej, 1e-10, "stderr")


def test_sharded_matches_single_device_statistically():
    opt = tp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.05, sigma=0.25)
    kw = dict(n_paths=160_000, n_steps=32, seed=5, dtype="float64")
    p8, se8 = tp.lsmc_price_sharded(get_mesh(devices=["cpu"] * 8), opt,
                                    "put", **kw)
    p1, se1 = tp.lsmc_price(opt, "put", device="cpu", **kw)
    assert abs(p8 - p1) < 5 * np.hypot(se8, se1)
    ref = tp.crr(opt, "put", N=2000, american=True, device="cpu")
    assert abs(p8 - ref) < max(5 * se8, 0.008 * ref)
    again = tp.lsmc_price_sharded(get_mesh(devices=["cpu"] * 8), opt, "put",
                                  **kw)
    assert again == (p8, se8)


def test_sharded_heston_matches_single_device():
    kw = dict(heston=HP, n_paths=1 << 15, n_steps=16, seed=3)
    p1, se1 = tp.lsmc_price(OPT, "put", device="cpu", **kw)
    pm, sem = tp.lsmc_price_sharded(get_mesh(devices=["cpu"] * 8), OPT,
                                    "put", **kw)
    assert abs(p1 - pm) < 4 * (se1 + sem) + 0.08, (p1, pm)




VGP = dict(sigma=0.2, theta=-0.14, nu=0.2)
NIGP = dict(alpha=8.0, beta=-4.0, delta=0.4)


def test_levy_lsmc_against_references():
    """tests/test_levy.py::TestAmericanLevy on the port: the VG American
    above its COS European and its intrinsic, the VG GBM limit against
    the lattice, the NIG two-pass."""
    opt = tp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.03, q=0.01,
                        sigma=0.2)
    am, se = tp.lsmc_price(opt, "put", vg=VGP, n_paths=50_000, n_steps=50,
                           seed=3, device="cpu")
    eu = float(tp.vg_price_cos(100.0, 105.0, 1.0, 0.03, 0.01, **VGP,
                               kind="put", device="cpu"))
    assert am > eu - 3.0 * se
    assert am >= 5.0 - 1e-9
    opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.03, sigma=0.2)
    am, se = tp.lsmc_price(opt, "put", vg=dict(sigma=0.2, theta=0.0,
                                               nu=1e-5),
                           n_paths=100_000, n_steps=50, seed=4,
                           device="cpu")
    ref = float(tp.crr(opt, "put", N=2000, american=True, device="cpu"))
    assert ref - 0.08 - 3.0 * se < am < ref + 3.0 * se + 0.01
    opt = tp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.03, q=0.01,
                        sigma=0.2)
    lo, se = tp.lsmc_price(opt, "put", nig=NIGP, n_paths=20_000,
                           n_steps=25, seed=5, bound="lower", device="cpu")
    assert se > 0.0 and lo > 0.0


def test_levy_paths_feed_the_same_backward():
    """A VG path matrix from the reference through both backward passes."""
    from optpricer_tpu.models.levy import vg_paths

    paths = vg_paths(100.0, 1.0, 0.05, 0.0, **VGP, n_steps=N_STEPS,
                     n_paths=N_PATHS, seed=7, dtype=F64)
    aj, at = _args(105.0, 0.05, N_STEPS, False)
    pj, sj = jam._lsmc_backward(paths, *aj, basis_dim=4)
    pt, st = tam._lsmc_backward(_t(paths), *at, basis_dim=4)
    _close(pt, pj, 1e-10, "price")
    _close(st, sj, 1e-10, "stderr")


