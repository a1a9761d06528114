"""The port as a package: it never imports jax, and it carries the JAX
package's containers across (``optpricer_tpu_torch/convert.py``)."""
import dataclasses
import fnmatch
import importlib
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

from optpricer_tpu import core as jcore
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import convert

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import optpricer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(" ".join(names))
"""


def test_import_never_pulls_in_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    for module in ("cli", "convert", "core", "dtypes", "_build",
                   "models.monte_carlo", "models.binomial", "models.mc_fused",
                   "models.analytic", "models.pde", "models.fem",
                   "ops.terminal_mc", "ops.path_mc", "ops.qmc_path",
                   "ops.sobol", "ops.swprng", "ops.tridiag", "ops.thomas",
                   "ops.fd_lv", "ops.grid", "ops.mc_batch",
                   "models.calibration", "models.processes",
                   "models.exotics", "risk",
                   "scripts.desk_workflow_localvol_barrier",
                   "models.basket", "models.lsv", "ops.bvn", "ops.basket_mc",
                   "utils.serialization", "utils.profiling", "utils.timing",
                   "validation", "models.american_analytic", "models.levy",
                   "models.mlmc", "models.american_mc", "models.heston_pde",
                   "models.forward_pde", "models.varswap", "models.cliquet",
                   "models.rough", "scripts.price_book",
                   "scripts.calibrate_surface"):
        assert f"optpricer_tpu_torch.{module}" in names, module


def test_packaging_installs_the_port():
    """``pyproject.toml`` installs the port's console script beside the
    reference's, and ships the port's ``py.typed`` and CUDA sources."""
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    scripts = meta["project"]["scripts"]
    assert scripts["optpricer-tpu"] == "optpricer_tpu.cli:main"
    module, _, attr = scripts["optpricer-tpu-torch"].partition(":")
    assert getattr(importlib.import_module(module), attr) \
        is tp.cli.main
    package_data = meta["tool"]["setuptools"]["package-data"]
    patterns = package_data["optpricer_tpu_torch"]
    pkg = REPO / "optpricer_tpu_torch"
    shipped = [p.relative_to(pkg).as_posix() for p in sorted(pkg.rglob("*"))
               if p.suffix in (".cu", ".cuh") or p.name == "py.typed"]
    assert "py.typed" in shipped and len(shipped) > 10
    for rel in shipped:
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


def test_public_names_resolve():
    """Every name the port exports is one of the reference's and resolves to
    a callable or a class (the option-kind constants equal the reference's);
    the three risk names are among them."""
    import optpricer_tpu as jp

    assert len(set(tp.__all__)) == len(tp.__all__)
    for name in tp.__all__:
        assert name in jp.__all__, name
        obj = getattr(tp, name)
        if name in ("CALL", "PUT"):
            assert obj == getattr(jp, name), name
        else:
            assert callable(obj) or isinstance(obj, type), name
    for name in ("ad_greeks", "portfolio_risk_fast", "exposure_profile"):
        assert name in tp.__all__, name
    assert "jax" not in repr(vars(tp)).lower().replace("optpricer_tpu", "")


# the names of the closed-form slice: validation, the analytic closed forms
# and COS pricers, the analytic Americans, the Lévy models and the
# American implied vol
SLICE_NAMES = (
    "cross_validate", "convergence_analysis", "stress_test",
    "backtest_delta_hedge",
    "merton_price", "heston_price_cos", "bates_price_cos", "quanto_price",
    "quanto_adjusted_carry", "sabr_implied_vol", "sabr_price_hagan",
    "fit_heston", "heston_greeks_cos", "cev_price", "barrier_price_bs",
    "chooser_price", "compound_price", "lookback_price_bs",
    "double_barrier_price_bs",
    "bjerksund_stensland_price", "baw_price", "rgw_price",
    "vg_price_cos", "nig_price_cos", "cgmy_price_cos", "vg_paths",
    "nig_paths", "fit_vg",
    "american_implied_vol",
)


def test_slice_names_keep_the_reference_parameters():
    """All 127 of the reference's names; each of the slice's 29 takes the
    reference's parameters, of the same kind and with the same defaults,
    and adds at most ``dtype=`` and ``device=``."""
    import inspect

    import optpricer_tpu as jp

    assert len(SLICE_NAMES) == 29 and len(tp.__all__) == 127
    assert set(tp.__all__) == set(jp.__all__)
    for name in SLICE_NAMES:
        assert name in tp.__all__, name
        ours = inspect.signature(getattr(tp, name)).parameters
        theirs = inspect.signature(getattr(jp, name)).parameters
        for pname, param in theirs.items():
            assert pname in ours, (name, pname)
            assert ours[pname].kind == param.kind, (name, pname)
            assert ours[pname].default == param.default, (name, pname)
        assert set(ours) - set(theirs) <= {"dtype", "device"}, name


# the American and multilevel Monte-Carlo slice, in the reference's order
MC_SLICE_NAMES = ("mlmc_price", "lsmc_price", "lsmc_price_batch",
                  "lsmc_price_sharded", "lsmc_price_basket")


@pytest.mark.parametrize("name", MC_SLICE_NAMES)
def test_mc_slice_names_keep_the_reference_parameters(name):
    """Each of the five takes the reference's parameters, in its order, of
    the same kind and with the same defaults, and adds at most
    ``device=``; the port lists them in the reference's order."""
    import inspect

    import optpricer_tpu as jp

    assert name in tp.__all__ and name in jp.__all__
    ours = inspect.signature(getattr(tp, name)).parameters
    theirs = inspect.signature(getattr(jp, name)).parameters
    assert list(ours)[:len(theirs)] == list(theirs), name
    for pname, param in theirs.items():
        assert ours[pname].kind == param.kind, (name, pname)
        assert ours[pname].default == param.default, (name, pname)
    assert set(ours) - set(theirs) <= {"device"}, name
    order = [n for n in jp.__all__ if n in MC_SLICE_NAMES]
    assert [n for n in tp.__all__ if n in MC_SLICE_NAMES] == order


# the Heston ADI, forward PDE, variance-swap, rough-vol and cliquet slice
PDE_SLICE_NAMES = (
    "heston_fd_price", "heston_fd_grid", "heston_fd_greeks",
    "heston_fd_price_batch", "heston_fd_price_barrier",
    "ForwardSurface", "dupire_forward_surface", "dupire_forward_price",
    "forward_surface_iv", "reprice_surface_forward",
    "varswap_strike_replication", "varswap_strike_heston",
    "varswap_strike_mc", "volswap_strike_mc",
    "forward_start_price", "cliquet_price_bs", "cliquet_price_mc",
    "rbergomi_paths", "rbergomi_price",
)


@pytest.mark.parametrize("name", PDE_SLICE_NAMES)
def test_pde_slice_names_keep_the_reference_parameters(name):
    """Each of the 19 takes the reference's parameters, in its order, of
    the same kind and with the same defaults, and adds at most
    ``device=``; ``ForwardSurface`` has the reference's fields and
    methods."""
    import inspect

    import optpricer_tpu as jp

    assert name in tp.__all__ and name in jp.__all__
    ours = inspect.signature(getattr(tp, name)).parameters
    theirs = inspect.signature(getattr(jp, name)).parameters
    assert list(ours)[:len(theirs)] == list(theirs), name
    for pname, param in theirs.items():
        assert ours[pname].kind == param.kind, (name, pname)
        assert ours[pname].default == param.default, (name, pname)
    assert set(ours) - set(theirs) <= {"device"}, name
    if name == "ForwardSurface":
        assert tp.ForwardSurface._fields == jp.ForwardSurface._fields
        assert inspect.signature(tp.ForwardSurface.price) == \
            inspect.signature(jp.ForwardSurface.price)


def test_option_spec_round_trip():
    j = jcore.OptionSpec(S0=101.0, K=99.5, T=0.7, r=0.02, sigma=0.25, q=0.01)
    t = convert.option_spec(j)
    assert isinstance(t, tp.OptionSpec)
    assert jcore.OptionSpec(**dataclasses.asdict(t)) == j


def test_instrument_and_market_round_trip():
    jinst, jmkt = jcore.to_instrument_market(
        jcore.OptionSpec(S0=100.0, K=90.0, T=0.5, r=0.03, sigma=0.3), "put")
    inst, mkt = convert.instrument(jinst), convert.market_data(jmkt)
    assert jcore.Instrument(**dataclasses.asdict(inst)) == jinst
    assert jcore.MarketData(**dataclasses.asdict(mkt)) == jmkt
    assert (inst, mkt) == tp.to_instrument_market(
        tp.OptionSpec(S0=100.0, K=90.0, T=0.5, r=0.03, sigma=0.3), "put")
    assert mkt.iv(90.0, 0.5) == 0.3


def test_array_valued_fields_become_tensors():
    j = jcore.OptionSpec(S0=100.0, K=np.array([90.0, 110.0]), T=1.0, r=0.0,
                         sigma=0.2)
    t = convert.option_spec(j)
    np.testing.assert_array_equal(t.K.numpy(), j.K)


def test_validation_matches_reference():
    for bad in (dict(S0=-1.0), dict(sigma=0.0), dict(T=0.0)):
        kw = dict(S0=100.0, K=100.0, T=1.0, r=0.0, sigma=0.2, **{})
        kw.update(bad)
        with pytest.raises(ValueError):
            jcore.OptionSpec(**kw)
        with pytest.raises(ValueError):
            tp.OptionSpec(**kw)
    with pytest.raises(ValueError):
        tp.Instrument(K=100.0, T=1.0, kind="straddle")
    with pytest.raises(ValueError):
        tp.Instrument(K=100.0, T=1.0, exercise="bermudan")


def test_host_vector_shapes_checked():
    with pytest.raises(ValueError):
        convert.terminal_params(np.zeros(6, np.float32))
    with pytest.raises(ValueError):
        convert.seed_pair(np.zeros(3, np.int32))


# ---------------------------------------------------------------------------
# JSON written by either package loads in the other
# ---------------------------------------------------------------------------
def _surfaces():
    from optpricer_tpu.models import calibration as jcal
    from optpricer_tpu_torch.models import calibration as tcal

    def build(lib, **kw):
        slices = {T: lib.SVIParams(a=0.02 * T + 0.01, b=0.15, rho=-0.3,
                                   m=0.02, sigma=0.12, expiry=T)
                  for T in (0.25, 1.0)}
        return lib.VolSurface(slices, forward_curve={0.25: 100.5, 1.0: 102.0},
                              **kw)

    return build(jcal), build(tcal, device="cpu")


def test_surface_json_round_trips_both_ways(tmp_path):
    from optpricer_tpu.utils import serialization as jsz
    from optpricer_tpu_torch.utils import serialization as tsz

    jsurf, tsurf = _surfaces()
    assert tsz.surface_to_json(tsurf) == jsz.surface_to_json(jsurf)
    tsz.save_surface(tsurf, tmp_path / "t.json")
    back = jsz.load_surface(tmp_path / "t.json")
    assert back.slices == jsurf.slices
    jsz.save_surface(jsurf, tmp_path / "j.json")
    got = tsz.load_surface(tmp_path / "j.json", device="cpu")
    assert {T: tsz.svi_to_dict(p) for T, p in got.slices.items()} == \
        {T: jsz.svi_to_dict(p) for T, p in jsurf.slices.items()}
    assert got.iv(95.0, 0.5) == pytest.approx(float(jsurf.iv(95.0, 0.5)),
                                              rel=1e-12)


def test_heston_and_basket_json_round_trips(tmp_path):
    from optpricer_tpu.utils import serialization as jsz
    from optpricer_tpu_torch.utils import serialization as tsz

    fit = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7, rmse=1e-3)
    tsz.save_heston(fit, tmp_path / "h.json")
    assert jsz.load_heston(tmp_path / "h.json") == tsz.heston_from_dict(fit)
    spec = dict(S0s=[100.0, 95.0], weights=[0.5, 0.5], sigmas=[0.2, 0.3],
                corr=[[1.0, 0.4], [0.4, 1.0]], qs=[0.01, 0.0])
    jsz.save_basket(tmp_path / "b.json", **spec)
    got = tsz.load_basket(tmp_path / "b.json")
    assert got["S0s"] == spec["S0s"] and got["qs"] == spec["qs"]
    np.testing.assert_array_equal(got["corr"], spec["corr"])
    with pytest.raises(KeyError):
        tsz.heston_from_dict(dict(v0=0.04))


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_lsv_json_round_trips_both_ways(tmp_path, scheme):
    import jax.numpy as jnp
    import torch

    from optpricer_tpu.models.lsv import LSVModel as JModel
    from optpricer_tpu.utils import serialization as jsz
    from optpricer_tpu_torch.utils import serialization as tsz

    rng = np.random.default_rng(0)
    x_bins = np.linspace(-1.0, 1.0, 9)
    lev = 1.0 + 0.1 * rng.standard_normal((4, 9))
    heston = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
    jm = JModel(S0=100.0, r=0.03, q=0.01, T=1.0, x_bins=jnp.asarray(x_bins),
                leverage=jnp.asarray(lev), scheme=scheme, **heston)
    jsz.save_lsv(jm, tmp_path / "j.json")
    tm = tsz.load_lsv(tmp_path / "j.json", device="cpu")
    assert isinstance(tm, tp.LSVModel) and tm.scheme == scheme
    assert tm.leverage.dtype == torch.float64
    np.testing.assert_array_equal(tm.leverage.numpy(), lev)
    np.testing.assert_array_equal(tm.x_bins.numpy(), x_bins)
    assert tsz.lsv_to_dict(tm) == jsz.lsv_to_dict(jm)
    tsz.save_lsv(tm, tmp_path / "t.json")
    back = jsz.load_lsv(tmp_path / "t.json")
    assert back.scheme == scheme and back.heston == jm.heston
    np.testing.assert_array_equal(np.asarray(back.leverage), lev)
    conv = convert.lsv_model(jm)
    assert tsz.lsv_to_dict(conv) == jsz.lsv_to_dict(jm)
    with pytest.raises(ValueError, match="inconsistent"):
        tsz.lsv_from_dict(dict(jsz.lsv_to_dict(jm), x_bins=[0.0, 1.0]),
                          device="cpu")
