"""Port vs reference: the fold_in chunk scan of ``monte_carlo``
(``backend="xla"``) and its mesh form.

* ``_chunk_stats`` and ``mc_sumstats`` fed the reference's own normals
  (``jax.random.normal(fold_in(key, chunk))``): the 13 sums at rtol 1e-12
  in float64, ragged tail and antithetic included;
* ``euro_price_mc(backend="xla")`` and ``euro_greeks_mc(backend="xla")``
  with the scan fed those normals: price and stderr, and every Greek, at
  rtol 1e-12 against the reference's calls;
* the port's own draws, keyed by (seed, chunk id): the chunk order does
  not change the sums, and the goldens are met statistically —
  ``mc_xla_call_seed42`` within 4·hypot(se, se_golden), and
  ``mc_greeks_xla_seed7`` (no stderr recorded) price, delta and vega
  within 4 se, the se from the spread of 8 seeds of the port's run at the
  golden's settings;
* ``mc_sumstats_sharded`` over 8 CPU shards against the one-device scan at
  rtol 1e-12, and ``euro_price_mc(mesh=, backend="xla")`` likewise.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optpricer_tpu as jp
from optpricer_tpu.models import monte_carlo as jmc
import optpricer_tpu_torch as tp
from optpricer_tpu_torch.models import monte_carlo as tmc
from optpricer_tpu_torch.parallel import get_mesh, mc_sumstats_sharded
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
ARGS = (100.0, 105.0, 0.75, 0.04, 0.01, 0.22)        # S0, K, T, r, q, sigma
F64 = jnp.float64


def _ref_normals(seed, chunk_size):
    key = jax.random.key(seed)
    return lambda c: np.array(jax.random.normal(
        jax.random.fold_in(key, c), (chunk_size,), F64))


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("antithetic", [True, False])
def test_chunk_scan_fed_reference_normals(is_call, antithetic):
    n_paths, chunk = 2500, 1000
    ref = np.asarray(jmc.mc_sumstats(
        jax.random.key(42), jnp.arange(3), jnp.asarray(n_paths),
        *[jnp.asarray(v, F64) for v in ARGS], jnp.asarray(is_call),
        chunk_size=chunk, antithetic=antithetic, dtype=F64))
    got = tmc.mc_sumstats(42, range(3), n_paths, *ARGS, is_call,
                          chunk_size=chunk, antithetic=antithetic,
                          dtype="float64", device="cpu",
                          normals=_ref_normals(42, chunk)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    assert got[0] == (2 if antithetic else 1) * n_paths
    # one chunk alone: the core
    core = tmc._chunk_stats(torch.from_numpy(_ref_normals(42, chunk)(2)), 2,
                            n_paths, *ARGS, is_call, chunk_size=chunk,
                            antithetic=antithetic, dtype=torch.float64)
    ref2 = np.asarray(jmc._chunk_stats(
        jax.random.key(42), 2, n_paths, *ARGS, is_call, chunk_size=chunk,
        antithetic=antithetic, dtype=F64))
    np.testing.assert_allclose(core.numpy(), ref2, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("control_variate", [True, False])
def test_xla_routes_fed_reference_normals(monkeypatch, control_variate):
    spec = dict(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22, q=0.01)
    kw = dict(n_paths=5000, seed=42, chunk_size=2000, backend="xla")
    ref = jp.euro_price_mc(jp.OptionSpec(**spec), "put",
                           control_variate=control_variate, **kw)
    ref_g = jp.euro_greeks_mc(jp.OptionSpec(**spec), "put", **kw)
    monkeypatch.setattr(tmc, "mc_sumstats", functools.partial(
        tmc.mc_sumstats, normals=_ref_normals(42, 2000)))
    got = tp.euro_price_mc(tp.OptionSpec(**spec), "put",
                           control_variate=control_variate, device="cpu",
                           **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    got_g = tp.euro_greeks_mc(tp.OptionSpec(**spec), "put", device="cpu",
                              **kw)
    assert got_g.keys() == ref_g.keys()
    for name, value in ref_g.items():
        assert got_g[name] == pytest.approx(value, rel=1e-12), name


def test_estimate_exact():
    s = tmc.mc_sumstats(3, range(2), 1500, *ARGS, True, chunk_size=1000,
                        antithetic=True, dtype="float64", device="cpu")
    for cv in (True, False):
        assert tmc._estimate(s, 100.0, 0.01, 0.75, cv) == \
            jmc._estimate(s.numpy(), 100.0, 0.01, 0.75, cv)
    assert np.isnan(tmc._estimate(np.zeros(13), 100.0, 0.0, 1.0, True)[0])


def test_chunk_draws_independent_of_order():
    kw = dict(chunk_size=1000, antithetic=True, dtype="float64",
              device="cpu")
    fwd = [tmc.mc_sumstats(5, [c], 4000, *ARGS, True, **kw)
           for c in range(4)]
    back = [tmc.mc_sumstats(5, [c], 4000, *ARGS, True, **kw)
            for c in reversed(range(4))][::-1]
    for a, b in zip(fwd, back):
        assert torch.equal(a, b)
    whole = tmc.mc_sumstats(5, range(4), 4000, *ARGS, True, **kw)
    torch.testing.assert_close(whole, sum(fwd), rtol=1e-12, atol=0.0)


def test_golden_price_met_statistically():
    golden = GOLDENS["mc_xla_call_seed42"]
    px, se = tp.euro_price_mc(tp.OptionSpec(S0=100.0, K=105.0, T=0.75,
                                            r=0.04, sigma=0.22, q=0.01),
                              "call", n_paths=200_000, seed=42,
                              backend="xla", dtype="float64", device="cpu")
    assert abs(px - golden["price"]) <= 4.0 * np.hypot(se, golden["stderr"])
    assert se == pytest.approx(golden["stderr"], rel=0.05)


def test_golden_greeks_met_statistically():
    golden = GOLDENS["mc_greeks_xla_seed7"]
    spec = tp.OptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22,
                         q=0.01)
    runs = [tp.euro_greeks_mc(spec, "call", n_paths=200_000, seed=s,
                              backend="xla", dtype="float64", device="cpu")
            for s in range(7, 15)]
    for name in ("price", "delta", "vega"):
        vals = np.array([g[name] for g in runs])
        se = vals.std(ddof=1)       # the spread of one run
        assert abs(vals[0] - golden[name]) <= 4.0 * se, name


def test_sharded_scan_equals_one_device():
    mesh = get_mesh(devices=["cpu"] * 8)
    one = tmc.mc_sumstats(7, range(10), 9500, *ARGS, True, chunk_size=1000,
                          antithetic=True, dtype="float64", device="cpu")
    shard = mc_sumstats_sharded(mesh, 7, 10, 9500, *ARGS, True,
                                chunk_size=1000, antithetic=True,
                                dtype=torch.float64)
    torch.testing.assert_close(shard, one, rtol=1e-12, atol=0.0)
    spec = tp.OptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22,
                         q=0.01)
    kw = dict(n_paths=9500, seed=7, chunk_size=1000, backend="xla")
    np.testing.assert_allclose(
        tp.euro_price_mc(spec, "call", mesh=mesh, **kw),
        tp.euro_price_mc(spec, "call", device="cpu", **kw), rtol=1e-12)
