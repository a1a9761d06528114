"""Port vs reference: the Longstaff-Schwartz passes under GBM, the strike
ladder and the Bermudan.

* The deterministic cores fed the reference's own path matrix (4 096
  antithetic paths x 16 dates, float64): ``_lsmc_backward`` (American and
  Bermudan) and ``_lsmc_forward_fixed_policy``, price and stderr at rtol
  1e-10; ``_lsmc_backward_betas`` at rtol 1e-9; the ladder's
  ``_lsmc_backward_batch`` at rtol 1e-10. An exercise decision is a
  discontinuous function of round-off: a price outside its tolerance is
  reported with the count of (path, date) decisions that the two policies
  take differently.
* The end-to-end GBM calls at tests/test_lsmc.py's sizes, oracles and
  tolerances (the port's ``crr`` and ``bs_price``).
* Every ``ValueError`` of ``lsmc_price`` with the reference's message; the
  ``lsmc`` CLI's lines equal to the port's calls, and within 4·hypot(se,
  se) of the reference CLI's (the two draw different samples).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optpricer_tpu as jp
from optpricer_tpu.models import american_mc as jam
from optpricer_tpu.models import processes as jpr
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import cli as tcli
from optpricer_tpu_torch.models import american_mc as tam
from tests.torch_threads import torch_one_thread  # noqa: F401

F64 = jnp.float64
N_STEPS, N_PATHS = 16, 2048          # 4 096 columns, antithetic
KW = dict(n_paths=200_000, n_steps=50, seed=0, dtype="float64",
          device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f64(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float64)


def _paths(S0=100.0, r=0.05, q=0.0, sigma=0.25, n_steps=N_STEPS, seed=3):
    return jpr.gbm_paths(S0, r, q, sigma, 1.0, n_steps, N_PATHS, seed=seed,
                         dtype=F64)


def _args(K, r, n_steps, is_call):
    return ((jnp.asarray(K, F64), jnp.asarray(r, F64),
             jnp.asarray(1.0 / n_steps, F64), jnp.asarray(is_call)),
            (_f64(K), _f64(r), _f64(1.0 / n_steps), np.bool_(is_call)))


def _flips(paths, K, is_call, betas_a, betas_b, basis_dim=4):
    """(path, date) exercise decisions that two policies take differently
    on the same paths."""
    S = np.asarray(paths)[1:-1]
    sign = 1.0 if is_call else -1.0
    ex = np.maximum(sign * (S - K), 0.0)
    X = np.stack([(S / K - 1.0) ** p for p in range(basis_dim)], -1)
    a = (ex > 0) & (ex > np.einsum("tnk,tk->tn", X, np.asarray(betas_a)))
    b = (ex > 0) & (ex > np.einsum("tnk,tk->tn", X, np.asarray(betas_b)))
    return int(np.sum(a != b))


def _close(got, want, rtol, what, flips=lambda: "not counted"):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), \
        f"{what}: {got!r} vs {want!r}; flipped decisions: {flips()}"


CASES = [("put", 110.0, 0.0), ("put", 90.0, 0.0), ("call", 95.0, 0.07),
         ("put", 130.0, 0.0)]


@pytest.mark.parametrize("kind,K,q", CASES)
def test_backward_matches_reference(kind, K, q):
    paths = _paths(q=q)
    aj, at = _args(K, 0.05, N_STEPS, kind == "call")
    bj = jam._lsmc_backward_betas(paths, *aj, basis_dim=4)
    bt = tam._lsmc_backward_betas(_t(paths), *at, basis_dim=4)
    np.testing.assert_allclose(bt.numpy(), np.array(bj), rtol=1e-9)
    pj, sj = jam._lsmc_backward(paths, *aj, basis_dim=4)
    pt, st = tam._lsmc_backward(_t(paths), *at, basis_dim=4)
    flips = lambda: _flips(paths, K, kind == "call", bj, bt)  # noqa: E731
    _close(pt, pj, 1e-10, "price", flips)
    _close(st, sj, 1e-10, "stderr", flips)


@pytest.mark.parametrize("kind,K,q", CASES[:3])
def test_forward_fixed_policy_matches_reference(kind, K, q):
    fit, fresh = _paths(q=q, seed=3), _paths(q=q, seed=4)
    aj, at = _args(K, 0.05, N_STEPS, kind == "call")
    bj = jam._lsmc_backward_betas(fit, *aj, basis_dim=4)
    pj, sj = jam._lsmc_forward_fixed_policy(fresh, bj, *aj, basis_dim=4)
    pt, st = tam._lsmc_forward_fixed_policy(_t(fresh), _t(bj), *at,
                                            basis_dim=4)
    _close(pt, pj, 1e-10, "price")
    _close(st, sj, 1e-10, "stderr")


@pytest.mark.parametrize("dates", [[0.25, 0.5, 0.75], [], [1e-3, 0.9],
                                   [j / 16 for j in range(1, 17)]])
def test_bermudan_backward_matches_reference(dates):
    paths = _paths()
    mask_j = jam._bermudan_mask(dates, 1.0, N_STEPS)
    mask_t = tam._bermudan_mask(dates, 1.0, N_STEPS)
    np.testing.assert_array_equal(mask_t, mask_j)
    aj, at = _args(100.0, 0.05, N_STEPS, False)
    pj, sj = jam._lsmc_backward(paths, *aj, jnp.asarray(mask_j), basis_dim=4)
    pt, st = tam._lsmc_backward(_t(paths), *at, mask_t, basis_dim=4)
    _close(pt, pj, 1e-10, "price")
    _close(st, sj, 1e-10, "stderr")


def test_bermudan_mask_refuses_dates_outside():
    for mod in (jam, tam):
        with pytest.raises(ValueError, match=r"outside \(0, T=1.0\]"):
            mod._bermudan_mask([1.5], 1.0, 8)
        with pytest.raises(ValueError, match="outside"):
            mod._bermudan_mask([0.0], 1.0, 8)


@pytest.mark.parametrize("basis_dim", [2, 4, 6])
def test_batch_ladder_matches_reference(basis_dim):
    paths = _paths()
    Ks = np.array([80.0, 95.0, 100.0, 110.0, 125.0, 105.0])
    mask = np.array([False, False, True, False, False, True])
    pj = jam._lsmc_backward_batch(paths, jnp.asarray(Ks), jnp.asarray(0.05),
                                  jnp.asarray(1 / N_STEPS), jnp.asarray(mask),
                                  basis_dim=basis_dim)
    pt = tam._lsmc_backward_batch(_t(paths), torch.tensor(Ks), _f64(0.05),
                                  _f64(1 / N_STEPS), mask,
                                  basis_dim=basis_dim)
    np.testing.assert_allclose(pt.numpy(), np.array(pj), rtol=1e-10)


def test_lsmc_price_batch_shape_and_kinds():
    out = tp.lsmc_price_batch(100.0, np.array([[95.0, 105.0]]), 1.0, 0.05,
                              0.02, 0.25, np.array([["call", "put"]]),
                              n_paths=20_000, n_steps=16, seed=2,
                              device="cpu")
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2)
    assert torch.all(out > 0)
    again = tp.lsmc_price_batch(100.0, np.array([[95.0, 105.0]]), 1.0, 0.05,
                                0.02, 0.25, np.array([["call", "put"]]),
                                n_paths=20_000, n_steps=16, seed=2,
                                device="cpu")
    assert torch.equal(out, again)


# -- end to end, tests/test_lsmc.py's and test_levy.py's oracles ---------
@pytest.mark.parametrize("K", [90.0, 105.0, 120.0])
def test_american_put_against_lattice(K):
    opt = tp.OptionSpec(S0=100.0, K=K, T=1.0, r=0.05, sigma=0.25)
    px, se = tp.lsmc_price(opt, "put", **KW)
    ref = tp.crr(opt, "put", N=2000, american=True, device="cpu")
    assert px <= ref + 5 * se
    assert abs(px - ref) < max(5 * se, 0.006 * ref)


def test_call_with_dividends_and_european_limits():
    opt = tp.OptionSpec(S0=100.0, K=95.0, T=1.0, r=0.03, sigma=0.25, q=0.07)
    px, se = tp.lsmc_price(opt, "call", **KW)
    ref = tp.crr(opt, "call", N=2000, american=True, device="cpu")
    assert abs(px - ref) < max(5 * se, 0.006 * ref)
    opt = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    px, se = tp.lsmc_price(opt, "call", **KW)
    assert abs(px - float(tp.bs_price(opt, "call", device="cpu"))) \
        < 5 * se + 0.03
    opt = tp.OptionSpec(S0=70.0, K=105.0, T=1.0, r=0.05, sigma=0.25)
    assert tp.lsmc_price(opt, "put", **KW)[0] >= 35.0 - 1e-9
    opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.06, sigma=0.25)
    px, _ = tp.lsmc_price(opt, "put", **KW)
    assert px > float(tp.bs_price(opt, "put", device="cpu")) + 0.1


def test_ladder_matches_scalar_calls():
    Ks = np.array([90.0, 100.0, 110.0])
    kw = dict(n_paths=100_000, n_steps=50, seed=1, dtype="float64",
              device="cpu")
    batch = tp.lsmc_price_batch(100.0, Ks, 1.0, 0.05, 0.0, 0.25, "put",
                                **kw).numpy()
    for k, got in zip(Ks, batch):
        opt = tp.OptionSpec(S0=100.0, K=float(k), T=1.0, r=0.05, sigma=0.25)
        single, se = tp.lsmc_price(opt, "put", **kw)
        assert abs(got - single) < se, (k, got, single, se)


def test_two_pass_is_low_biased():
    opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.25)
    ref = tp.crr(opt, "put", N=4000, american=True, device="cpu")
    kw = dict(n_paths=100_000, n_steps=16, seed=1, dtype="float64",
              device="cpu")
    lo, lo_se = tp.lsmc_price(opt, "put", bound="lower", **kw)
    single, s_se = tp.lsmc_price(opt, "put", **kw)
    assert abs(lo - single) < 5 * np.hypot(lo_se, s_se)
    assert lo < ref + 3 * lo_se


class TestBermudan:
    """tests/test_lsmc.py::TestBermudan on the port."""

    OPT = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    KW = dict(n_paths=40_000, n_steps=24, seed=9, device="cpu")

    def test_limits_and_monotonicity(self):
        eu = float(tp.bs_price(self.OPT, "put", device="cpu"))
        pe, se = tp.lsmc_price(self.OPT, "put", exercise_dates=[], **self.KW)
        assert abs(pe - eu) < 4.0 * se + 1e-3, (pe, eu)
        pq, _ = tp.lsmc_price(self.OPT, "put",
                              exercise_dates=[0.25, 0.5, 0.75], **self.KW)
        pm, _ = tp.lsmc_price(self.OPT, "put",
                              exercise_dates=[i / 12 for i in range(1, 12)],
                              **self.KW)
        pa, _ = tp.lsmc_price(self.OPT, "put", **self.KW)
        assert pq <= pm + 1e-9
        assert pm <= pa + 0.02
        pb, _ = tp.lsmc_price(self.OPT, "put",
                              exercise_dates=[i / 24 for i in range(1, 24)],
                              **self.KW)
        assert abs(pb - pa) < 1e-6, (pb, pa)

    def test_date_rounding_to_zero_clamps_to_first_node(self):
        p_tiny, _ = tp.lsmc_price(self.OPT, "put", exercise_dates=[1e-3],
                                  **self.KW)
        p_none, _ = tp.lsmc_price(self.OPT, "put", exercise_dates=[],
                                  **self.KW)
        p_first, _ = tp.lsmc_price(self.OPT, "put", exercise_dates=[1 / 24],
                                   **self.KW)
        assert abs(p_tiny - p_first) < 1e-9
        assert p_tiny >= p_none - 1e-9

    def test_crr_bermudan_monotone_in_dates(self):
        opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.25)
        eu = tp.crr(opt, "put", N=4000, device="cpu")
        b4 = tp.crr(opt, "put", N=4000, device="cpu",
                    exercise_dates=[j / 4 for j in range(1, 4)])
        b16 = tp.crr(opt, "put", N=4000, device="cpu",
                     exercise_dates=[j / 16 for j in range(1, 16)])
        am = tp.crr(opt, "put", N=4000, american=True, device="cpu")
        assert eu < b4 < b16 < am


# -- errors and the CLI ----------------------------------------------------
HP = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
VGP = dict(sigma=0.2, theta=-0.14, nu=0.2)
NIGP = dict(alpha=8.0, beta=-4.0, delta=0.4)


def _errors(lsv_model):
    yield dict(bound="upper"), "bound must be None, 'lower' or 'both'"
    yield dict(heston=HP, vg=VGP), "pass at most one of heston="
    yield dict(exercise_dates=[0.5], bound="lower"), "single-pass"
    yield dict(exercise_dates=[1.5]), "outside"
    yield dict(heston=HP, exercise_dates=[0.5], bound="both"), \
        "single-pass"
    yield dict(vg=VGP, bound="both"), "not wired for the Lévy"
    yield dict(nig=NIGP, exercise_dates=[0.5], bound="lower"), \
        "single-pass"
    yield dict(lsv=lsv_model, exercise_dates=[0.5], bound="lower"), \
        "single-pass"


@pytest.mark.parametrize("case", range(8))
def test_value_errors_match_reference(case):
    def model(pkg, lin, ones):
        return pkg.LSVModel(S0=100.0, r=0.05, q=0.0, T=1.0, **HP,
                            x_bins=lin(-1.0, 1.0, 5), leverage=ones((4, 5)))

    runs = [(jp, jp.OptionSpec, model(jp, jnp.linspace, jnp.ones), {}),
            (tp, tp.OptionSpec, model(tp, torch.linspace, torch.ones),
             dict(device="cpu"))]
    for pkg, spec, lsv_model, extra in runs:
        opt = spec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
        kw, msg = list(_errors(lsv_model))[case]
        with pytest.raises(ValueError, match=msg):
            pkg.lsmc_price(opt, "put", n_paths=1000, n_steps=8, **kw,
                           **extra)


def test_lsv_model_must_match_the_option():
    model = tp.LSVModel(S0=100.0, r=0.05, q=0.0, T=1.0, **HP,
                        x_bins=torch.linspace(-1.0, 1.0, 5),
                        leverage=torch.ones((4, 5)))
    opt = tp.OptionSpec(S0=101.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    with pytest.raises(ValueError, match="disagrees with the calibrated"):
        tp.lsmc_price(opt, "put", lsv=model, device="cpu")


def _line(text):
    value, rest = text.split("  (stderr ")
    return float(value), float(rest.rstrip(")"))


def test_cli_lsmc_lines(capsys):
    flags = ["lsmc", "--S0", "100", "--K", "110", "--T", "1", "--r", "0.05",
             "--sigma", "0.25", "--kind", "put", "--n-paths", "20000",
             "--n-steps", "16", "--seed", "3"]
    tcli.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.strip()
    opt = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.05, sigma=0.25)
    px, se = tp.lsmc_price(opt, "put", n_paths=20_000, n_steps=16, seed=3,
                           device="cpu")
    assert got == f"{px:.10f}  (stderr {se:.10f})"
    from optpricer_tpu import cli as jcli

    jcli.main(flags)
    ref_px, ref_se = _line(capsys.readouterr().out.strip())
    assert abs(px - ref_px) < 4 * np.hypot(se, ref_se)
    # the dual's nested rollouts at the CLI's n_inner 256 x 8 192 paths:
    # 4 dates keep it to seconds
    bound = flags[:-3] + ["4", "--seed", "3", "--bound", "--device", "cpu"]
    tcli.main(bound)
    lines = capsys.readouterr().out.strip().splitlines()
    br = tp.lsmc_price(opt, "put", n_paths=20_000, n_steps=4, seed=3,
                       bound="both", device="cpu")
    (lo, lo_se), (up, up_se) = br["lower"], br["upper"]
    assert lines == [f"lower  {lo:.10f}  (stderr {lo_se:.10f})",
                     f"upper  {up:.10f}  (stderr {up_se:.10f})",
                     f"gap    {br['gap']:.10f}"]
