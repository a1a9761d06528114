"""The port's spans at its layer boundaries (``utils/profiling.annotate``).

Each Monte Carlo entry the benchmark drives, called on the CPU under a
``torch.profiler``, records one ``optpricer.call`` holding, in order, the
host preparation, the copies to the device, the kernel wrapper's launch,
the read of the results and the host estimator; the five kinds never nest
in one another. The spans are host events and not user annotations, so
the profiler puts no copy of them on a device's timeline. With no
profiler recording no span is entered, and the prices are those of the
traced call bit for bit.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import optpricer_tpu_torch as tp
from optpricer_tpu_torch.ops.mc_batch import euro_price_mc_batch
from optpricer_tpu_torch.utils import profiling
from tests.torch_threads import torch_one_thread  # noqa: F401

KINDS = ("prepare", "copy", "launch", "read", "estimate")


def _surface():
    sl = {T: tp.SVIParams(a=0.02 * T + 0.02, b=0.15, rho=-0.3, m=0.02,
                          sigma=0.12, expiry=T) for T in (0.25, 0.5, 1.0)}
    return tp.VolSurface(sl, forward_curve={T: 100 * np.exp(0.03 * T)
                                            for T in sl}, device="cpu")


ENTRIES = {
    "exotic_price_mc": (lambda: tp.exotic_price_mc(
        "asian", 100.0, 105.0, 1.0, 0.03, 0.01, sigma=0.2, n_steps=4,
        n_paths=2048, control_variate=True, seed=2**31 + 11, device="cpu"),
        "path_mc", 2),
    "exotic_price_mc_dupire": (lambda: tp.exotic_price_mc_dupire(
        "barrier", _surface(), 100.0, 100.0, 1.0, 0.03, 0.0,
        scheme="milstein", control_variate=True, n_steps=4, n_paths=2048,
        barrier=130.0, seed=2**31 + 11, device="cpu"), "path_mc", 3),
    "euro_price_mc_batch": (lambda: euro_price_mc_batch(
        100.0, np.linspace(90.0, 110.0, 5), 1.0, 0.03, 0.0, 0.2, "put",
        n_paths=2048, seed=2**31 + 11, device="cpu"), "mc_batch", 3),
}


def _traced(call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    spans = sorted((ev.start_ns(), -ev.end_ns(), ev.name(),
                    ev.is_user_annotation())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("optpricer."))
    return out, [(s, -e, name, user) for s, e, name, user in spans]


def _kind(name):
    return name.split(".")[1]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_follow_the_layers_in_order(entry):
    call, kernel, copies = ENTRIES[entry]
    _, spans = _traced(call)
    (s0, e0, root, _), rest = spans[0], spans[1:]
    assert root == "optpricer.call"
    assert [name for *_, name, _ in spans].count("optpricer.call") == 1
    assert all(s0 <= s and e <= e0 for s, e, *_ in rest)
    kinds = [_kind(name) for _, _, name, _ in rest]
    collapsed = [k for i, k in enumerate(kinds) if i == 0 or kinds[i - 1] != k]
    assert collapsed == list(KINDS)
    assert kinds.count("copy") == copies
    assert kinds.count("read") == 1
    assert [name for _, _, name, _ in rest
            if _kind(name) == "launch"] == [f"optpricer.launch.{kernel}"]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_span_kinds_never_nest(entry):
    _, spans = _traced(ENTRIES[entry][0])
    rest = spans[1:]
    for (s1, e1, n1, _), (s2, e2, n2, _) in zip(rest, rest[1:]):
        assert e1 <= s2, (n1, n2)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_are_host_events_not_user_annotations(entry):
    """A user annotation (``record_function``) would be copied onto the
    device's timeline over the work launched in it, where it would count
    as device time."""
    _, spans = _traced(ENTRIES[entry][0])
    assert spans and not any(user for *_, user in spans)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_untraced_call_enters_no_span_and_prices_alike(entry, monkeypatch):
    call = ENTRIES[entry][0]
    traced, _ = _traced(call)

    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    plain = call()
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_annotate_is_one_shared_no_op_when_off():
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("a"):
        pass


def test_annotated_keeps_the_function():
    @profiling.annotated("optpricer.test")
    def f(x, *, y=2):
        """doc"""
        return x + y

    assert f(1) == 3 and f.__name__ == "f" and f.__doc__ == "doc"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(1, y=3)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("optpricer.test") == 1
