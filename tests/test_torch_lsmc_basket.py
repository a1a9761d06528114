"""Port vs reference: the multi-asset American LSMC (``lsmc_price_basket``)
and the ``basket --american`` CLI.

* ``_ma_core`` fed the reference's own normals equals its
  ``_ma_path_matrix`` (rtol 1e-13); ``_lsmc_backward_ma`` (price, stderr)
  and ``_lsmc_forward_fixed_policy_ma`` fed the reference's path matrix at
  rtol 1e-10, for ``basket``, ``rainbow_max`` and ``rainbow_min``, calls
  and puts, on one, two and three assets (4 096 paths x 9 dates,
  float64); the betas of the two-pass fit at rtol 1e-9 on three assets,
  where the 9-feature basis has full rank. On one asset (y2 ≡ 0) and on
  two equally weighted ones (b = (y1 + y2)/2) the basis is rank-deficient
  and β is fixed by the ridge alone, so round-off reaches it amplified by
  cond(XᵀWX) ~ 1e18; there the policy β defines, the fitted continuation
  X·β at every date, is held to 1e-9 of its largest value.
* tests/test_american_basket.py on the port, with its sizes, oracles and
  tolerances: the Andersen-Broadie (2004) max-call 13.902 within 0.08 and
  21.345 within 0.10, the premium over the European, the structural
  limits; every ``ValueError`` (and the Cholesky's ``LinAlgError``) as the
  reference raises it.
* ``basket --american`` prints the port's ``lsmc_price_basket`` line.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import american_mc as jam
import optpricer_tpu as jp
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import cli as tcli
from optpricer_tpu_torch.models import american_mc as tam
from tests.torch_threads import torch_one_thread  # noqa: F401

F64 = jnp.float64
N_STEPS, N_PATHS = 9, 4096
BOOKS = {
    1: ([100.0], [1.0], [0.02], [0.25], [[1.0]]),
    2: ([100.0, 95.0], [0.5, 0.5], [0.1, 0.05], [0.2, 0.3],
        [[1.0, 0.3], [0.3, 1.0]]),
    3: ([100.0, 95.0, 105.0], [0.2, 0.5, 0.3], [0.1, 0.0, 0.05],
        [0.2, 0.3, 0.25],
        [[1.0, 0.3, 0.1], [0.3, 1.0, 0.5], [0.1, 0.5, 1.0]]),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _paths(a, seed=4):
    S0s, w, qs, sig, corr = BOOKS[a]
    gen = [jnp.asarray(x, F64) for x in (S0s, 0.05, qs, sig,
                                         np.linalg.cholesky(corr), 3.0)]
    key = jax.random.key(seed)
    ref = jam._ma_path_matrix(key, *gen, n_steps=N_STEPS, n_paths=N_PATHS,
                              antithetic=True)
    z = jax.random.normal(key, (N_STEPS, N_PATHS // 2, a), F64)
    got = tam._ma_core(_t(z), *(_t(x) for x in gen), antithetic=True)
    return ref, got


@pytest.mark.parametrize("a", [1, 2, 3])
def test_path_matrix_matches_reference(a):
    ref, got = _paths(a)
    np.testing.assert_allclose(got.numpy(), np.array(ref), rtol=1e-13)


def _close(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), f"{what}: {got!r} vs {want!r}"


@pytest.mark.parametrize("a", [1, 2, 3])
@pytest.mark.parametrize("payoff", ["basket", "rainbow_max", "rainbow_min"])
@pytest.mark.parametrize("kind", ["call", "put"])
def test_basket_passes_match_reference(a, payoff, kind):
    fit, _ = _paths(a, seed=4)
    fresh, _ = _paths(a, seed=5)
    K = 100.0
    bw = [jnp.asarray(x, F64) for x in (BOOKS[a][1], K, 0.05, 3.0 / N_STEPS,
                                        1.0 if kind == "call" else -1.0)]
    bw_t = [_t(x) for x in bw]
    pj, sj = jam._lsmc_backward_ma(fit, *bw, payoff=payoff)
    pt, st = tam._lsmc_backward_ma(_t(fit), *bw_t, payoff=payoff)
    _close(pt, pj, 1e-10, "price")
    _close(st, sj, 1e-10, "stderr")
    bj = jam._lsmc_backward_ma(fit, *bw, payoff=payoff, two_pass=True)
    bt = tam._lsmc_backward_ma(_t(fit), *bw_t, payoff=payoff, two_pass=True)
    if a == 3:
        np.testing.assert_allclose(bt.numpy(), np.array(bj), rtol=1e-9)
    else:
        # rank-deficient basis (one asset: y2 ≡ 0; two equal weights:
        # b = (y1 + y2)/2): β is fixed by the ridge alone and carries the
        # round-off of XᵀWX times cond ~1e18; the policy it defines, the
        # fitted continuation X·β at every date, is what must agree
        for t in range(1, N_STEPS):
            X = jam._ma_basis(fit[t], bw[0], bw[1])
            want = np.array(X @ bj[t - 1])
            got = np.array(X) @ bt[t - 1].numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-9 * np.max(np.abs(want)))
    pj, sj = jam._lsmc_forward_fixed_policy_ma(fresh, bj, *bw, payoff=payoff)
    pt, st = tam._lsmc_forward_fixed_policy_ma(_t(fresh), _t(bj), *bw_t,
                                               payoff=payoff)
    _close(pt, pj, 1e-10, "two-pass price")
    _close(st, sj, 1e-10, "two-pass stderr")


AB = dict(sigmas=[0.2, 0.2], corr=np.eye(2), qs=[0.10, 0.10],
          payoff="rainbow_max", kind="call", n_steps=9, device="cpu")


def test_andersen_broadie_max_call():
    p, se = tp.lsmc_price_basket([100.0, 100.0], [0.5, 0.5], 100.0, 3.0,
                                 0.05, n_paths=400_000, seed=11, **AB)
    assert se < 0.05
    assert abs(p - 13.902) < 0.08, p
    p, se = tp.lsmc_price_basket([110.0, 110.0], [0.5, 0.5], 100.0, 3.0,
                                 0.05, n_paths=400_000, seed=11,
                                 bound="lower", **AB)
    assert abs(p - 21.345) < 0.10, p


def test_exceeds_european_and_two_pass_close():
    am, se1 = tp.lsmc_price_basket([100.0, 100.0], [0.5, 0.5], 100.0, 3.0,
                                   0.05, n_paths=200_000, seed=3, **AB)
    eu, eu_se = tp.basket_price_mc(
        [100.0, 100.0], [0.5, 0.5], 100.0, 3.0, 0.05, qs=[0.10, 0.10],
        sigmas=[0.2, 0.2], corr=np.eye(2), payoff="rainbow_max",
        kind="call", n_paths=2**20, seed=3, device="cpu")
    assert am > eu + 2.0 * eu_se
    kw = dict(AB, n_paths=200_000, seed=13)
    p1, s1 = tp.lsmc_price_basket([100.0, 100.0], [0.5, 0.5], 100.0, 3.0,
                                  0.05, **kw)
    p2, s2 = tp.lsmc_price_basket([100.0, 100.0], [0.5, 0.5], 100.0, 3.0,
                                  0.05, bound="lower", **kw)
    assert abs(p1 - p2) < 4.0 * (s1 + s2)


def test_structural_limits():
    args = ([95.0, 105.0], [0.5, 0.5], 100.0, 1.0, 0.05)
    kw = dict(sigmas=[0.25, 0.2], corr=np.array([[1.0, 0.3], [0.3, 1.0]]),
              device="cpu")
    am, am_se = tp.lsmc_price_basket(*args, payoff="rainbow_max",
                                     kind="call", n_paths=400_000,
                                     n_steps=12, seed=5, **kw)
    eu, eu_se = tp.basket_price_mc(*args, payoff="rainbow_max", kind="call",
                                   n_paths=2**21, seed=5, **kw)
    assert abs(am - eu) < 3.0 * (am_se + eu_se) + 0.02
    opt = tp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.05, sigma=0.25)
    ref, ref_se = tp.lsmc_price(opt, "put", n_paths=200_000, n_steps=25,
                                seed=7, device="cpu")
    got, got_se = tp.lsmc_price_basket(
        [100.0], [1.0], 105.0, 1.0, 0.05, sigmas=[0.25], corr=np.eye(1),
        payoff="basket", kind="put", n_paths=200_000, n_steps=25, seed=7,
        device="cpu")
    assert abs(got - ref) < 3.0 * (ref_se + got_se) + 0.02
    args = ([100.0, 100.0], [0.6, 0.4], 105.0, 1.0, 0.06)
    kw = dict(sigmas=[0.2, 0.3], corr=np.array([[1.0, 0.5], [0.5, 1.0]]),
              device="cpu")
    am, _ = tp.lsmc_price_basket(*args, payoff="basket", kind="put",
                                 n_paths=200_000, n_steps=25, seed=9, **kw)
    eu, eu_se = tp.basket_price_mc(*args, payoff="basket", kind="put",
                                   n_paths=2**20, seed=9, **kw)
    assert am > eu + 2.0 * eu_se
    args = ([100.0, 100.0], [0.5, 0.5], 100.0, 1.0, 0.05)
    kw = dict(sigmas=[0.2, 0.25], corr=np.array([[1.0, 0.2], [0.2, 1.0]]),
              kind="put", n_paths=100_000, n_steps=12, seed=2, device="cpu")
    worst, _ = tp.lsmc_price_basket(*args, payoff="rainbow_max", **kw)
    best, _ = tp.lsmc_price_basket(*args, payoff="rainbow_min", **kw)
    assert best > worst


BAD = [
    (dict(payoff="spread", sigmas=[0.2, 0.2], corr=np.eye(2)), ValueError,
     "payoff must be"),
    (dict(bound="both", sigmas=[0.2, 0.2], corr=np.eye(2)), ValueError,
     "bound must be None or 'lower'"),
    (dict(kind="straddle", sigmas=[0.2, 0.2], corr=np.eye(2)), ValueError,
     "kind must be"),
    (dict(weights=[0.7, 0.5], sigmas=[0.2, 0.2], corr=np.eye(2)),
     ValueError, "non-negative and sum"),
    (dict(sigmas=[0.2], corr=np.eye(2)), ValueError, "length-a"),
    (dict(sigmas=[0.2, 0.2], corr=np.array([[1.0, 2.0], [2.0, 1.0]])),
     np.linalg.LinAlgError, None),
]


@pytest.mark.parametrize("bad,exc,msg", BAD)
def test_bad_arguments_raise_as_reference(bad, exc, msg):
    kw = dict(bad)
    w = kw.pop("weights", [0.5, 0.5])
    for fn, extra in ((jp.lsmc_price_basket, {}),
                      (tp.lsmc_price_basket, dict(device="cpu"))):
        with pytest.raises(exc, match=msg):
            fn([100.0, 100.0], w, 100.0, 1.0, 0.05, n_paths=1000,
               n_steps=4, **kw, **extra)


@pytest.mark.parametrize("payoff,kind", [("rainbow_max", "call"),
                                         ("basket", "put")])
def test_cli_basket_american(payoff, kind, capsys):
    flags = ["basket", "--S0s", "100,95,105", "--sigmas", "0.2,0.3,0.25",
             "--rho", "0.4", "--K", "100", "--T", "1", "--r", "0.03",
             "--qs", "0.05,0.02,0.0", "--payoff", payoff, "--kind", kind,
             "--n-steps", "8", "--n-paths", "8192", "--seed", "6",
             "--american", "--device", "cpu"]
    tcli.main(flags)
    got = capsys.readouterr().out.strip()
    corr = 0.4 * np.ones((3, 3)) + 0.6 * np.eye(3)
    px, se = tp.lsmc_price_basket([100.0, 95.0, 105.0], [1 / 3] * 3, 100.0,
                                  1.0, 0.03, [0.05, 0.02, 0.0],
                                  sigmas=[0.2, 0.3, 0.25], corr=corr,
                                  kind=kind, payoff=payoff, n_paths=8192,
                                  n_steps=8, seed=6, device="cpu")
    assert got == f"{px:.10f}  (stderr {se:.10f})"
    flags[flags.index("--payoff") + 1] = "asian_basket"
    with pytest.raises(SystemExit, match="--american supports"):
        tcli.main(flags)
