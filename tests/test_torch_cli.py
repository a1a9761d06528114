"""Port CLI vs reference CLI.

``bs`` and ``binomial`` are deterministic f64 engines: the printed
10-decimal strings must be identical. ``mc`` and ``greeks`` draw from
different generators in the two CLIs on the CPU (the reference takes its
``fold_in`` chunk scan there, the port its terminal kernel), so they agree
within Monte-Carlo error: 4 combined standard errors for the price, and
for the Greeks bands at 2^20 paths scaled from tests/test_mc_greeks.py.
"""
import pytest

from optpricer_tpu import cli as jcli
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
