"""Port CLI vs reference CLI.

``bs``, ``binomial`` and ``fd`` are deterministic f64 engines: the printed
10-decimal strings must be identical. ``mc`` and ``greeks`` draw from
different generators in the two CLIs on the CPU (the reference takes its
``fold_in`` chunk scan there, the port its terminal kernel), so they agree
within Monte-Carlo error: 4 combined standard errors for the price, and
for the Greeks bands at 2^20 paths scaled from tests/test_mc_greeks.py.
``qmc`` on ``--device cpu`` must print exactly what the port's own
``exotic_price_mc(backend="qmc", device="cpu")`` gives, at 10 decimals, and
so must ``basket`` and ``lsv`` (the latter calibrating on a surface file
written by the JAX package and pricing again from its saved model), and
``basket --american`` the port's ``lsmc_price_basket``. The closed-form
subcommands ``heston`` (COS, Bates), ``american`` (bs2002, baw, rgw),
``barrier`` (analytic and fd, single and double), ``lookback`` and
``levy`` (vg, nig, cgmy) print what the port's in-process call gives, and
the reference CLI's line too (deterministic f64 engines); so do
``heston``'s ADI, ``--american``, ``--barrier`` and ``--dividends`` routes
(the Heston ADI PDE, its grid defaults cut to 48 x 24 x 64 in both
packages for the test) and ``varswap``'s closed-form lines; ``varswap
--mc`` prints the port's own calls, within Monte-Carlo error of the
reference's.
"""
import numpy as np
import pytest
import torch

from optpricer_tpu import cli as jcli
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import cli as tcli
from tests.torch_threads import torch_one_thread  # noqa: F401

MARKET = ["--S0", "100", "--K", "110", "--T", "1", "--r", "0.03",
          "--sigma", "0.2"]


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.strip()


@pytest.mark.parametrize("argv", [
    ["bs", *MARKET],
    ["bs", *MARKET, "--q", "0.01", "--kind", "put"],
    ["binomial", *MARKET, "--N", "200"],
    ["binomial", *MARKET, "--N", "200", "--american", "--kind", "p"],
])
def test_deterministic_outputs_identical(argv, capsys):
    ref = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == ref


def _mc_line(text):
    value, rest = text.split("  (stderr ")
    return float(value), float(rest.rstrip(")"))


@pytest.mark.parametrize("kind", ["call", "put"])
def test_mc_agrees_within_error(kind, capsys):
    argv = ["mc", *MARKET, "--kind", kind, "--n-paths", "200000",
            "--seed", "42"]
    ref_px, ref_se = _mc_line(_run(jcli.main, argv, capsys))
    px, se = _mc_line(_run(tcli.main, argv + ["--device", "cpu"], capsys))
    assert abs(px - ref_px) <= 4.0 * (se * se + ref_se * ref_se) ** 0.5


def test_greeks_agree_within_error(capsys):
    argv = ["greeks", *MARKET, "--n-paths", str(1 << 20), "--seed", "5"]
    ref = _run(jcli.main, argv, capsys).splitlines()
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys).splitlines()
    names = [line.split()[0] for line in ref]
    assert [line.split()[0] for line in got] == names
    bands = dict(price=0.02, delta=3e-3, gamma=1.5e-3, vega=0.3, theta=0.08,
                 rho=0.3)
    for ref_line, got_line in zip(ref, got):
        name = ref_line.split()[0]
        assert abs(float(got_line.split()[1]) - float(ref_line.split()[1])) \
            <= bands[name], name


@pytest.mark.parametrize("extra, payoff, kw", [
    (["--n-paths", "2048", "--n-steps", "8"], "vanilla",
     dict(n_paths=2048, n_steps=8)),
    (["--payoff", "asian", "--average-type", "geometric", "--kind", "put",
      "--n-paths", "4096", "--n-steps", "16", "--seed", "3"], "asian",
     dict(average_type="geometric", kind="put", n_paths=4096, n_steps=16,
          seed=3)),
    (["--payoff", "barrier", "--barrier", "125", "--n-paths", "3000",
      "--n-steps", "12"], "barrier",
     dict(barrier=125.0, n_paths=3000, n_steps=12)),
])
def test_qmc_line_equals_port_entry_point(extra, payoff, kw, capsys):
    argv = ["qmc", *MARKET, *extra, "--device", "cpu"]
    got = _run(tcli.main, argv, capsys)
    defaults = dict(n_paths=65_536, n_steps=64, seed=0)
    px, se = tp.exotic_price_mc(payoff, 100.0, 110.0, 1.0, 0.03,
                                sigma=0.2, backend="qmc", device="cpu",
                                **(defaults | kw))
    assert got == f"{px:.10f}  (stderr {se:.10f})"


@pytest.mark.parametrize("extra", [
    [],
    ["--american", "--kind", "put", "--N-S", "96", "--N-t", "48"],
    ["--dividends", "0.3:1.5,0.7:2", "--N-S", "80", "--N-t", "40"],
    ["--american", "--dividends", "0.5:3", "--N-S", "64", "--N-t", "32"],
])
def test_fd_line_identical(extra, capsys):
    argv = ["fd", *MARKET, *extra]
    ref = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == ref


BASKET = ["--S0s", "100,95,105", "--sigmas", "0.2,0.3,0.25", "--K", "100",
          "--T", "1", "--r", "0.03", "--rho", "0.4", "--device", "cpu"]


@pytest.mark.parametrize("extra, kw", [
    (["--n-paths", "4096", "--seed", "3"], dict(payoff="basket")),
    (["--payoff", "rainbow_min", "--kind", "put", "--n-paths", "4096",
      "--seed", "4"], dict(payoff="rainbow_min", kind="put")),
    (["--payoff", "worstof_barrier", "--barrier", "80",
      "--barrier-type", "down-and-out", "--n-steps", "8", "--n-paths",
      "4096", "--seed", "5"],
     dict(payoff="worstof_barrier", barrier=80.0,
          barrier_type="down-and-out", n_steps=8)),
])
def test_basket_line_equals_port_entry_point(extra, kw, capsys):
    got = _run(tcli.main, ["basket", *BASKET, *extra], capsys)
    S0s, sigmas = [100.0, 95.0, 105.0], [0.2, 0.3, 0.25]
    corr = 0.4 * np.ones((3, 3)) + 0.6 * np.eye(3)
    common = dict(sigmas=sigmas, corr=corr, kind=kw.pop("kind", "call"),
                  n_paths=4096, seed=int(extra[extra.index("--seed") + 1]),
                  device="cpu")
    if kw["payoff"] == "worstof_barrier":
        px, se = tp.basket_exotic_mc(S0s, [1 / 3] * 3, 100.0, 1.0, 0.03,
                                     None, **kw, **common)
    else:
        px, se = tp.basket_price_mc(S0s, [1 / 3] * 3, 100.0, 1.0, 0.03,
                                    None, **kw, **common)
    assert got == f"{px:.10f}  (stderr {se:.10f})"


def test_basket_american_is_not_ported(capsys):
    """Named for the route's state before the basket LSMC was ported:
    ``basket --american`` now prints ``lsmc_price_basket``'s line."""
    got = _run(tcli.main, ["basket", *BASKET, "--american", "--payoff",
                           "rainbow_max", "--n-steps", "8", "--n-paths",
                           "4096", "--seed", "3"], capsys)
    corr = 0.4 * np.ones((3, 3)) + 0.6 * np.eye(3)
    px, se = tp.lsmc_price_basket([100.0, 95.0, 105.0], [1 / 3] * 3, 100.0,
                                  1.0, 0.03, None, sigmas=[0.2, 0.3, 0.25],
                                  corr=corr, kind="call",
                                  payoff="rainbow_max", n_paths=4096,
                                  n_steps=8, seed=3, device="cpu")
    assert got == f"{px:.10f}  (stderr {se:.10f})"


def test_lsv_line_equals_port_entry_point(tmp_path, capsys):
    """Calibrate on a surface file written by the JAX package, save the
    model, then price from the saved model: both lines equal the same
    calls in-process."""
    from optpricer_tpu.models.calibration import SVIParams, VolSurface
    from optpricer_tpu.utils import serialization as jsz

    slices = {T: SVIParams(a=0.03 * T, b=0.12 * T, rho=-0.4, m=0.0,
                           sigma=0.25, expiry=T) for T in (0.25, 0.5, 1.0)}
    surf = tmp_path / "surface.json"
    jsz.save_surface(VolSurface(slices, forward_curve={
        T: 100.0 * np.exp(0.03 * T) for T in slices}), surf)
    model_path = tmp_path / "lsv.json"
    flags = ["lsv", *MARKET, "--n-steps", "8", "--cal-paths", "2048",
             "--n-bins", "32", "--n-paths", "4096", "--seed", "2",
             "--device", "cpu"]
    got = _run(tcli.main, flags + ["--surface", str(surf), "--save-model",
                                   str(model_path)], capsys)
    from optpricer_tpu_torch.utils import serialization as tsz

    model = tp.lsv_calibrate(tsz.load_surface(surf, device="cpu"),
                             dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5,
                                  rho=-0.6), 100.0, 0.03, 0.0, T=1.0,
                             n_steps=8, n_paths=2048, n_bins=32, seed=2,
                             device="cpu")
    px, se = tp.lsv_price_mc("vanilla", model, 110.0, n_paths=4096, seed=2,
                             device="cpu")
    assert got == f"{px:.10f}  (stderr {se:.10f})"
    saved = tsz.load_lsv(model_path, device="cpu")
    assert torch.equal(saved.leverage, model.leverage)
    again = _run(tcli.main, flags + ["--model", str(model_path), "--payoff",
                                     "barrier", "--barrier", "130"], capsys)
    px, se = tp.lsv_price_mc("barrier", saved, 110.0, n_paths=4096, seed=2,
                             barrier=130.0, device="cpu")
    assert again == f"{px:.10f}  (stderr {se:.10f})"


def _closed_form_call(cmd, extra):
    """The port's in-process call behind each closed-form subcommand line
    (``MARKET``: S0 100, K 110, T 1, r 0.03, σ 0.2, q 0)."""
    from optpricer_tpu_torch.models import (american_analytic as am,
                                            analytic as an, levy, pde)

    S0, K, T, r, sig = 100.0, 110.0, 1.0, 0.03, 0.2
    spec = tp.OptionSpec(S0=S0, K=K, T=T, r=r, sigma=sig)
    opt = dict(zip(extra[::2], extra[1::2]))
    kind = "put" if opt.get("--kind") == "put" else "call"
    cpu = dict(device="cpu")
    heston = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6)
    if cmd == "heston":
        if "--lam" in opt:
            return an.bates_price_cos(S0, K, T, r, 0.0, **heston, lam=0.3,
                                      mJ=-0.1, sJ=0.15, kind=kind, **cpu)
        return an.heston_price_cos(S0, K, T, r, 0.0, **heston, kind=kind,
                                   **cpu)
    if cmd == "american":
        if "--D" in opt:
            return am.rgw_price(S0, K, T, r, sigma=sig, D=3.0, t_div=0.5,
                                **cpu)
        engine = am.baw_price if opt.get("--engine") == "baw" \
            else am.bjerksund_stensland_price
        return engine(S0, K, T, r, 0.0, sigma=sig, kind=kind, **cpu)
    if cmd == "barrier":
        fd = opt.get("--engine") == "fd"
        if "--lower" in opt:
            kw = dict(lower=80.0, upper=130.0, knock=opt.get("--knock",
                                                             "out"))
            if fd:
                return pde.fd_price_double_barrier(spec, kind, **kw, N_S=96,
                                                   N_t=48, **cpu)
            return an.double_barrier_price_bs(S0, K, T, r, 0.0, sigma=sig,
                                              kind=kind, **kw, **cpu)
        if fd:
            return pde.fd_price_barrier(spec, kind, 130.0, "up-and-out",
                                        rebate=1.0, N_S=96, N_t=48,
                                        barrier_mode="operator", **cpu)
        return an.barrier_price_bs(S0, K, T, r, 0.0, sigma=sig, barrier=90.0,
                                   barrier_type="down-and-in", kind=kind,
                                   **cpu)
    if cmd == "lookback":
        return an.lookback_price_bs(S0, T, r, 0.0, sigma=sig, kind=kind,
                                    strike_type=opt.get("--strike-type",
                                                        "floating"),
                                    K=K, **cpu)
    model = opt.get("--model", "vg")
    if model == "vg":
        return levy.vg_price_cos(S0, K, T, r, 0.0, sigma=sig, theta=-0.14,
                                 nu=0.2, kind=kind, **cpu)
    if model == "nig":
        return levy.nig_price_cos(S0, K, T, r, 0.0, alpha=8.0, beta=-4.0,
                                  delta=0.4, kind=kind, **cpu)
    return levy.cgmy_price_cos(S0, K, T, r, 0.0, C=0.5, G=5.0, M=9.0, Y=0.8,
                               kind=kind, **cpu)


@pytest.mark.parametrize("cmd, extra", [
    ("heston", []),
    ("heston", ["--kind", "put"]),
    ("heston", ["--lam", "0.3", "--mJ", "-0.1", "--sJ", "0.15"]),
    ("american", []),
    ("american", ["--kind", "put"]),
    ("american", ["--engine", "baw", "--kind", "put"]),
    ("american", ["--D", "3", "--t-div", "0.5"]),
    ("barrier", ["--barrier", "90", "--barrier-type", "down-and-in"]),
    ("barrier", ["--barrier", "130", "--rebate", "1", "--engine", "fd",
                 "--N-S", "96", "--N-t", "48"]),
    ("barrier", ["--lower", "80", "--upper", "130", "--kind", "put"]),
    ("barrier", ["--lower", "80", "--upper", "130", "--knock", "in",
                 "--engine", "fd", "--N-S", "96", "--N-t", "48"]),
    ("lookback", []),
    ("lookback", ["--strike-type", "fixed", "--kind", "put"]),
    ("levy", []),
    ("levy", ["--model", "nig", "--kind", "put"]),
    ("levy", ["--model", "cgmy"]),
])
def test_closed_form_lines(cmd, extra, capsys):
    argv = [cmd, *MARKET, *extra]
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == f"{float(_closed_form_call(cmd, extra)):.10f}"
    assert got == _run(jcli.main, argv, capsys)


@pytest.fixture
def small_adi_grid(monkeypatch):
    """Both packages' Heston ADI grid defaults cut to 48 x 24 x 64."""
    from optpricer_tpu.models import heston_pde as jh
    from optpricer_tpu_torch.models import heston_pde as th

    for mod in (jh, th):
        for fn in (mod.heston_fd_price, mod.heston_fd_grid):
            for name, value in (("n_x", 48), ("n_v", 24), ("n_t", 64)):
                monkeypatch.setitem(fn.__kwdefaults__, name, value)


@pytest.mark.parametrize("extra", [["--engine", "adi"], ["--american"],
                                   ["--barrier", "130"],
                                   ["--dividends", "0.5:2"]])
def test_heston_pde_routes_are_not_ported(extra, small_adi_grid, capsys):
    """The name predates the port of the Heston ADI PDE: each of its routes
    now prints the reference CLI's line."""
    argv = ["heston", *MARKET, *extra]
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == _run(jcli.main, argv, capsys)
    assert float(got) > 0.0


def test_heston_pde_guards(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["heston", *MARKET, "--barrier", "130", "--dividends",
                   "0.5:2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["heston", *MARKET, "--lam", "0.3", "--american",
                   "--device", "cpu"])


VARSWAP = ["varswap", "--S0", "100", "--T", "1", "--r", "0.03"]


@pytest.mark.parametrize("extra", [[], ["--sigma", "0.3", "--q", "0.01"],
                                   ["--v0", "0.05", "--theta", "0.04"]])
def test_varswap_lines(extra, capsys):
    argv = VARSWAP + extra
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert got == _run(jcli.main, argv, capsys)
    assert got.startswith("fair variance (continuous): ")


@pytest.mark.parametrize("extra", [[], ["--v0", "0.04"]])
def test_varswap_mc_lines(extra, capsys):
    argv = VARSWAP + extra + ["--mc", "--n-steps", "32", "--n-paths",
                              "8192", "--seed", "3"]
    got = _run(tcli.main, argv + ["--device", "cpu"], capsys).splitlines()
    ref = _run(jcli.main, argv, capsys).splitlines()
    assert got[0] == ref[0] and len(got) == len(ref) == 3
    dyn = (dict(heston=dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4,
                            rho=-0.6)) if extra else dict(sigma=0.2))
    kw = dict(n_steps=32, n_paths=8192, seed=3, device="cpu")
    kd, se = tp.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, **dyn, **kw)
    assert got[1] == f"fair variance (32 fixings): {kd:.8f}  (stderr {se:.2e})"
    ref_kd = float(ref[1].split(": ")[1].split()[0])
    ref_se = float(ref[1].split("stderr ")[1].rstrip(")"))
    assert abs(kd - ref_kd) <= 4.0 * np.hypot(se, ref_se)
    vs, vse = tp.volswap_strike_mc(100.0, 0.03, 0.0, 1.0, **dyn, **kw)
    assert got[2].startswith(f"fair volatility (32 fixings): "
                             f"{100.0 * vs:.4f}  (stderr {100.0 * vse:.2e};")
