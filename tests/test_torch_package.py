"""The port as a package: it never imports jax, and it carries the JAX
package's containers across (``optpricer_tpu_torch/convert.py``)."""
import dataclasses
import subprocess
import sys
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
                   "scripts.desk_workflow_localvol_barrier"):
        assert f"optpricer_tpu_torch.{module}" in names, module


def test_public_names_resolve():
    for name in tp.__all__:
        assert getattr(tp, name) is not None
    assert "jax" not in repr(vars(tp)).lower().replace("optpricer_tpu", "")


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
