"""Port vs reference: multilevel Monte Carlo (``mlmc_price``).

* ``_level_y`` fed the reference's own draws — its ``fold_in(key, k)``,
  ``split`` and ``normal`` calls for fine step k, in a Python loop where
  the reference has a scan — at every dynamics (GBM, Heston, local vol
  under log-Euler and Milstein) and payoff, level 0 and a correction
  level, float64: each path's Y within 1e-12 of max(the largest |Y|, 1);
  the level stats [n, ΣY, ΣY²] likewise (``_stats_close``).
* The pathwise Greeks' tangents are held in ``test_torch_mlmc_tangents.py``.
* The Giles loop: both packages' chunk-stats functions replaced by one
  deterministic function of (level, chunk); ``price``, ``stderr``, the
  Greeks and ``info`` equal key for key.
* The mesh: the port's shards fed the reference's per-device draws and
  summed in mesh order against the reference's sharded chunk on the
  8-device CPU mesh (1e-12).
* Every ``ValueError`` with the reference's message; the ``mlmc`` CLI
  line equal to the port's call, and to the reference CLI's within
  4·hypot(se, se) + 2·eps (the two draw different samples). The oracles
  of tests/test_mlmc.py are in ``test_torch_mlmc_oracles.py``.
* ``monte_carlo.keyed_generator``: the one-index form draws what it drew
  before the tuple form was added (the chunk scan's 13 sums, recorded
  bit for bit), and a tuple keys the stream of JAX's nested ``fold_in``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import mlmc as jml
import optpricer_tpu as jp
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import cli as tcli
from optpricer_tpu_torch.models import mlmc as tml
from optpricer_tpu_torch.models.monte_carlo import keyed_generator, mc_sumstats
from optpricer_tpu_torch.ops.swprng import jax_fold_in_path_bits
from tests.torch_threads import torch_one_thread  # noqa: F401

F64 = jnp.float64
S0, K, T, R, Q, SIG = 100.0, 100.0, 1.0, 0.05, 0.0, 0.2
HP = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.3, rho=-0.5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _fixed_pair(**kw):
    base = dict(S0=S0, K=K, T=T, r=R, q=0.01, sigma=SIG, barrier=130.0,
                rebate=0.5, payout=1.5, bump=0.01, h_v0=HP["v0"],
                h_kappa=HP["kappa"], h_theta=HP["theta"], h_xi=HP["xi"],
                h_rho=HP["rho"])
    base.update(kw)
    return ({k: jnp.asarray(v, F64) for k, v in base.items()},
            {k: torch.tensor(v, dtype=torch.float64) for k, v in base.items()})


def _ref_draw(key, n, heston):
    """``draw(k)`` with the reference scan body's normals for fine step k."""
    def draw(k):
        k1, k2 = jax.random.split(jax.random.fold_in(key, k))
        z1 = _t(jax.random.normal(k1, (n,), F64))
        return z1, _t(jax.random.normal(k2, (n,), F64)) if heston else None
    return draw


def _sig_jax(S, t):
    return 0.2 * (jnp.maximum(S, 1e-8) / 100.0) ** -0.3 + 0.05 * t


def _sig_torch(S, t):
    return 0.2 * (torch.clamp(S, min=1e-8) / 100.0) ** -0.3 + 0.05 * t


# id: (model_kind, payoff, fixed overrides, static overrides)
CASES = {
    "gbm-vanilla-put": ("gbm", "vanilla", {}, dict(kind="put")),
    "gbm-barrier-up-out": ("gbm", "barrier", {}, {}),
    "gbm-barrier-down-in-put": ("gbm", "barrier", dict(barrier=85.0),
                                dict(barrier_type="down-and-in",
                                     kind="put")),
    "gbm-asian-arith": ("gbm", "asian", {}, {}),
    "gbm-asian-geo-floating": ("gbm", "asian", {},
                               dict(average_type="geometric",
                                    strike_type="floating")),
    "gbm-digital": ("gbm", "digital", dict(K=95.0), {}),
    "gbm-lookback-fixed": ("gbm", "lookback", {}, {}),
    "gbm-lookback-floating-put": ("gbm", "lookback", {},
                                  dict(strike_type="floating", kind="put")),
    "heston-vanilla": ("heston", "vanilla", {}, {}),
    "heston-barrier-up-in": ("heston", "barrier", {},
                             dict(barrier_type="up-and-in")),
    "lv-euler-asian": ("localvol", "asian", {}, {}),
    "lv-milstein-barrier": ("localvol", "barrier", {},
                            dict(scheme="milstein")),
    "lv-milstein-lookback": ("localvol", "lookback", {},
                             dict(scheme="milstein")),
}
N = 400


def _static(case, level0):
    mk, payoff, _, over = CASES[case]
    static = dict(payoff=payoff, kind="call", model_kind=mk, n_coarse=4,
                  M=2, n_paths=N, antithetic=True, barrier_type="up-and-out",
                  average_type="arithmetic", strike_type="fixed",
                  level0=level0, scheme="euler")
    static.update(over)
    return static


def _sigma_locs(mk):
    if mk != "localvol":
        return dict(sigma_loc=None), dict(sigma_loc=None)
    return dict(sigma_loc=_sig_jax), dict(sigma_loc=_sig_torch)


def _stats_close(got, want, rtol, what):
    """Counts equal; a signed sum within rtol·max(√(n·Σ(·)²), n), a sum of
    squares within rtol·max(Σ(·)², 2√(n·Σ(·)²) + n): relative to the
    stat's scale, or to one unit a path where every path's value is round-
    off (the exact GBM step couples a vanilla's or a digital's fine and
    coarse terminals exactly)."""
    got, want = got.numpy(), np.array(want)
    assert got[0] == want[0], what
    n = want[0]
    for i in range(1, len(want), 2):
        root = np.sqrt(n * want[i + 1])
        assert abs(got[i] - want[i]) <= rtol * max(root, n), \
            (what, i, got, want)
        assert abs(got[i + 1] - want[i + 1]) \
            <= rtol * max(want[i + 1], 2.0 * root + n), \
            (what, i + 1, got, want)


@pytest.mark.parametrize("level0", [True, False], ids=["level0", "level2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_level_y_matches_reference(case, level0):
    mk, _, fixed_over, _ = CASES[case]
    jf, tf = _fixed_pair(**fixed_over)
    static = _static(case, level0)
    sj, st = _sigma_locs(mk)
    key = jax.random.key(3)
    yj = np.array(jml._level_y(key, jf, dtype=F64, **sj, **static))
    draw = _ref_draw(key, N, mk == "heston")
    yt = tml._level_y(draw, tf, dtype=torch.float64, **st, **static).numpy()
    # a unit floor: the exact-coupling levels' Y are round-off (~1e-13)
    scale = max(np.max(np.abs(yj)), 1.0)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12 * scale)
    want = jml._mlmc_level_stats(key, jf, dtype=F64, **sj, **static)
    got = tml._mlmc_level_stats(_ref_draw(key, N, mk == "heston"), tf,
                                dtype=torch.float64, **st, **static)
    _stats_close(got, want, 1e-12, case)


# -- the Giles loop, on one deterministic chunk function ---------------
def _chunk_sums(level, chunk, n_stats, n_paths):
    """Stats of a synthetic chunk: deterministic in (level, chunk), with
    means and variances that decay with the level like a real MLMC run."""
    rng = np.random.default_rng([level, chunk])
    y = 2.0 ** -level * (0.3 + rng.standard_normal(n_paths))
    out = [float(n_paths), y.sum(), (y * y).sum()]
    for i in range((n_stats - 3) // 2):
        g = 2.0 ** -level * (0.1 * i + rng.standard_normal(n_paths))
        out += [g.sum(), (g * g).sum()]
    return np.array(out)


@pytest.mark.parametrize("kw", [
    dict(payoff="asian", sigma=SIG, eps=0.01),
    dict(payoff="barrier", sigma=SIG, eps=0.005, barrier=130.0,
         greeks=True),
    dict(payoff="vanilla", heston=HP, eps=0.02, greeks=True, L_max=3),
    dict(payoff="asian", sigma=SIG, eps=0.002, M=4, n0_steps=4, L_min=1,
         chunk=4096, max_paths_per_level=1 << 18),
], ids=["asian", "barrier-greeks", "heston-greeks-Lmax", "M4-capped"])
def test_giles_loop_matches_reference(kw, monkeypatch):
    n0, M = kw.get("n0_steps", 8), kw.get("M", 2)
    n_greeks = 3 if kw.get("greeks") else 0
    counts = {}

    def level_of(n_coarse, level0):
        return 0 if level0 else 1 + round(np.log(n_coarse / n0) / np.log(M))

    def ref_stub(key, fixed, *, n_coarse, n_paths, level0, **static):
        level = level_of(n_coarse, level0)
        chunk = counts.setdefault(level, 0)
        counts[level] += 1
        return _chunk_sums(level, chunk, 3 + 2 * n_greeks, 2 * n_paths)

    def port_stub(seed, level, chunk, fixed, *, mesh, device, n_coarse,
                  n_paths, level0, **static):
        assert level == level_of(n_coarse, level0)
        return torch.from_numpy(_chunk_sums(level, chunk, 3 + 2 * n_greeks,
                                            2 * n_paths))

    monkeypatch.setattr(jml, "_mlmc_level_stats", ref_stub)
    monkeypatch.setattr(tml, "_chunk_stats", port_stub)
    want = jml.mlmc_price(S0=S0, K=K, T=T, r=R, q=Q, seed=1,
                          return_info=True, **kw)
    got = tml.mlmc_price(S0=S0, K=K, T=T, r=R, q=Q, seed=1,
                         return_info=True, device="cpu", **kw)
    assert got[:-1] == want[:-1]
    info_t, info_j = got[-1], want[-1]
    assert set(info_t) == set(info_j)
    for key in info_j:
        if key == "weak_remainder" and np.isnan(info_j[key]):
            assert np.isnan(info_t[key])
        else:
            assert info_t[key] == info_j[key], key


# -- the mesh -------------------------------------------------------------
def test_sharded_chunk_matches_reference():
    """Each shard of the port fed the reference's per-device draws
    (``fold_in(key, device)``): the mesh-order sum of the shards equals the
    reference's sharded chunk."""
    from optpricer_tpu.parallel import get_mesh as jmesh
    from optpricer_tpu_torch.parallel.mesh import mesh_sum

    jf, tf = _fixed_pair()
    static = _static("gbm-barrier-up-out", False)
    static.pop("n_paths")
    key = jax.random.key(8)
    want = jml._mlmc_level_stats_sharded(jmesh(8), key, jf, n_paths=8 * 64,
                                         dtype=F64, sigma_loc=None,
                                         greek_params=("S0",), **static)
    parts = [tml._mlmc_level_stats(
        _ref_draw(jax.random.fold_in(key, d), 64, False), tf, n_paths=64,
        dtype=torch.float64, sigma_loc=None, greek_params=("S0",), **static)
        for d in range(8)]
    _stats_close(mesh_sum(parts), want, 1e-12, "sharded")


BAD = [
    (("swing",), dict(sigma=SIG), "unknown payoff"),
    (("vanilla",), {}, "exactly one"),
    (("vanilla",), dict(sigma=SIG, heston=HP), "exactly one"),
    (("vanilla",), dict(sigma=SIG, M=1), "M must"),
    (("vanilla",), dict(sigma=SIG, kind="straddle"), "kind must"),
    (("vanilla",), dict(sigma=SIG, scheme="heun"), "unknown scheme"),
    (("vanilla",), dict(sigma=SIG, scheme="milstein"), "requires sigma_loc"),
    (("vanilla",), dict(sigma=SIG, barrier_type="up"), "barrier_type"),
    (("vanilla",), dict(sigma=SIG, average_type="harmonic"), "average_type"),
    (("vanilla",), dict(sigma=SIG, strike_type="mixed"), "strike_type"),
    (("vanilla",), dict(heston=dict(v0=0.04)), "missing keys"),
    (("vanilla",), dict(sigma=SIG, L_min=3, L_max=2), "L_min <= L_max"),
    (("digital",), dict(sigma=SIG, greeks=True), "pathwise"),
]


@pytest.mark.parametrize("args,kw,msg", BAD)
def test_value_errors_match_reference(args, kw, msg):
    with pytest.raises(ValueError, match=msg):
        jp.mlmc_price(*args, S0, K, T, R, Q, **kw)
    with pytest.raises(ValueError, match=msg):
        tp.mlmc_price(*args, S0, K, T, R, Q, device="cpu", **kw)


def test_cli_mlmc_line(capsys):
    flags = ["mlmc", "--S0", "100", "--K", "100", "--T", "1", "--r", "0.05",
             "--sigma", "0.2", "--payoff", "barrier", "--barrier", "130",
             "--eps", "0.05", "--seed", "7"]
    tcli.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.strip()
    px, se = tp.mlmc_price("barrier", 100.0, 100.0, 1.0, 0.05, 0.0,
                           sigma=0.2, eps=0.05, seed=7, barrier=130.0,
                           device="cpu")
    assert got == f"{px:.10f}  (stderr {se:.10f})"
    from optpricer_tpu import cli as jcli

    jcli.main(flags)
    value, rest = capsys.readouterr().out.strip().split("  (stderr ")
    assert abs(px - float(value)) < 4 * np.hypot(se, float(rest[:-1])) \
        + 2 * 0.05


# -- keyed_generator -------------------------------------------------------
# the chunk scan's 13 sums (seed 123, 3 chunks of 1 024, 2 500 paths,
# antithetic, f64) as keyed_generator's one-index form drew them before the
# tuple form existed
CHUNK_SUMS = [
    "0x1.3880000000000p+12", "0x1.7a1908121759cp+14",
    "0x1.3863019234239p+19", "0x1.e340647e4a8d9p+18",
    "0x1.84995b6b70864p+25", "0x1.896be0b848529p+21",
    "0x1.8716ecc007773p+10", "0x1.7b87f6a16fa5dp+10",
    "0x1.6eec5d78b4b2cp+14", "0x1.740663a1d288ep+17",
    "0x1.247136dea76aap+15", "0x1.0342b72e2bea6p+16",
    "0x1.b14a10b64b9c5p+10"]


def test_keyed_generator_one_index_form_unchanged():
    s = mc_sumstats(123, range(3), 2500, 100.0, 110.0, 1.0, 0.03, 0.01, 0.2,
                    True, chunk_size=1024, antithetic=True,
                    dtype=torch.float64, device="cpu")
    assert [float(x).hex() for x in s] == CHUNK_SUMS
    for seed, i in ((0, 0), (7, 3), (2**40 + 5, 2**31 + 7)):
        assert keyed_generator(seed, i, "cpu").initial_seed() \
            == keyed_generator(seed, (i,), "cpu").initial_seed()
    assert [keyed_generator(s_, i, "cpu").initial_seed()
            for s_, i in ((0, 0), (7, 3), (2**40 + 5, 2**31 + 7))] \
        == [15537955143741890140, 4267362494576114307, 11933764099516142854]


@pytest.mark.parametrize("path", [(3,), (0, 5), (2, 7, 11), (2**31, 1, 0)])
def test_keyed_generator_tuple_is_nested_fold_in(path):
    key = jax.random.key(2**35 + 17)
    for i in path:
        key = jax.random.fold_in(key, i)
    want = np.array(jax.random.bits(key, (2,), jnp.uint32)).tolist()
    assert jax_fold_in_path_bits(2**35 + 17, path, 2) == want
    hi, lo = want
    assert keyed_generator(2**35 + 17, path, "cpu").initial_seed() \
        == (hi << 32) | lo
