"""The American ladder with its error bars (``models.american_mc.lsmc_ladder``)
and its spans.

* Its prices are ``lsmc_price_batch``'s, and both are the backward pass's
  on the same paths, bit for bit, at float32 and float64; its standard
  errors are ``_lsmc_backward_batch(return_stderr=True)``'s.
* Under a CPU ``torch.profiler`` it records one ``optpricer.call`` holding,
  in order, the host preparation, the two copies (strikes, kind mask), the
  paths, the date loop and the one read; with no profiler it enters no
  span and gives the same numbers.
* It is a module function, not a public name of the package: the package
  keeps the JAX package's names.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import optpricer_tpu_torch as tp
from optpricer_tpu_torch.models import american_mc as tam
from optpricer_tpu_torch.models.processes import gbm_paths
from tests.torch_threads import torch_one_thread  # noqa: F401

SEED = 2**31 + 4099
KS = np.linspace(70.0, 130.0, 32)
KW = dict(n_paths=2048, n_steps=10, basis_dim=4, antithetic=True, seed=SEED,
          device="cpu")
SPANS = ["optpricer.prepare", "optpricer.copy", "optpricer.copy",
         "optpricer.paths", "optpricer.lsmc.backward", "optpricer.read"]
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _ladder(**over):
    kw = dict(KW, **over)
    return tam.lsmc_ladder(99.5, KS, 1.0, 0.03, 0.0, 0.2, "put", **kw)


def _backward(dtype, kinds):
    """The backward pass on the ladder's path matrix, its inputs made
    outside the ladder's path: the scalars from the host, the kind mask a
    numpy array."""
    dt = DTYPES[dtype]
    paths = gbm_paths(99.5, 0.03, 0.0, 0.2, 1.0, KW["n_steps"],
                      KW["n_paths"], antithetic=True, seed=SEED, dtype=dt,
                      device="cpu")
    return tam._lsmc_backward_batch(
        paths, torch.as_tensor(KS, dtype=dt), torch.as_tensor(0.03, dtype=dt),
        torch.as_tensor(1.0 / KW["n_steps"], dtype=dt), kinds, basis_dim=4,
        return_stderr=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ladder_prices_are_the_batch_s_bit_for_bit(dtype):
    price, _ = _ladder(dtype=dtype)
    batch = tp.lsmc_price_batch(99.5, KS, 1.0, 0.03, 0.0, 0.2, "put",
                                dtype=dtype, **KW)
    want, _ = _backward(dtype, np.zeros(len(KS), bool))
    assert batch.dtype == DTYPES[dtype] and batch.shape == KS.shape
    assert price.dtype == np.float64
    np.testing.assert_array_equal(price, batch.numpy().astype(np.float64))
    np.testing.assert_array_equal(price, want.numpy().astype(np.float64))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ladder_stderr_is_the_backward_pass_s(dtype):
    _, se = _ladder(dtype=dtype)
    _, want = _backward(dtype, np.zeros(len(KS), bool))
    assert se.dtype == np.float64 and np.all(se > 0.0)
    np.testing.assert_array_equal(se, want.numpy().astype(np.float64))


def test_ladder_keeps_the_strikes_shape_and_kinds():
    K = KS.reshape(4, 8)
    kinds = np.where(np.arange(32) % 2 == 0, "call", "put").reshape(4, 8)
    price, se = tam.lsmc_ladder(99.5, K, 1.0, 0.03, 0.0, 0.2, kinds,
                                dtype="float64", **KW)
    want, want_se = _backward("float64", (kinds == "call").reshape(-1))
    assert price.shape == se.shape == (4, 8)
    np.testing.assert_array_equal(price.reshape(-1), want.numpy())
    np.testing.assert_array_equal(se.reshape(-1), want_se.numpy())


def test_ladder_is_a_seed_s_and_not_a_package_name():
    a, b = _ladder(dtype="float32"), _ladder(dtype="float32")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    other, _ = _ladder(dtype="float32", seed=SEED + 1)
    assert not np.array_equal(a[0], other)
    assert "lsmc_ladder" not in tp.__all__
    assert "lsmc_ladder" not in tam.__all__


def _traced(call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    spans = sorted((ev.start_ns(), -ev.end_ns(), ev.name(),
                    ev.is_user_annotation())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("optpricer."))
    return out, [(s, -e, name, user) for s, e, name, user in spans]


def test_ladder_records_its_spans_under_one_call():
    _, spans = _traced(lambda: _ladder(dtype="float32"))
    (s0, e0, root, _), rest = spans[0], spans[1:]
    assert root == "optpricer.call"
    assert [name for _, _, name, _ in rest] == SPANS
    assert all(s0 <= s and e <= e0 for s, e, *_ in rest)
    # one after another: none holds another
    for (s1, e1, n1, _), (s2, e2, n2, _) in zip(rest, rest[1:]):
        assert e1 <= s2, (n1, n2)
    assert not any(user for *_, user in spans)


def test_batch_records_the_same_spans_but_no_read():
    _, spans = _traced(lambda: tp.lsmc_price_batch(
        99.5, KS, 1.0, 0.03, 0.0, 0.2, "put", dtype="float32", **KW))
    assert [name for _, _, name, _ in spans] == ["optpricer.call"] + \
        SPANS[:-1]


def test_untraced_ladder_enters_no_span_and_prices_alike(monkeypatch):
    traced, _ = _traced(lambda: _ladder(dtype="float32"))

    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    plain = _ladder(dtype="float32")
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype, basis_dim", [("float32", 4), ("float64", 4),
                                              ("float32", 3)])
def test_batch_pass_off_the_card_is_the_plain_torch_pass(dtype, basis_dim,
                                                         monkeypatch):
    """Off the card the ladder's backward pass never reaches the CUDA date
    loop (``ops.lsmc``): at float32 and float64 on the CPU, and at any
    basis, it is the plain torch pass, bit for bit, calls and puts mixed."""
    from optpricer_tpu_torch.ops import lsmc

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU pass took the CUDA date loop")

    monkeypatch.setattr(lsmc, "lsmc_backward", refuse)
    dt = DTYPES[dtype]
    paths = gbm_paths(99.5, 0.03, 0.0, 0.2, 1.0, KW["n_steps"],
                      KW["n_paths"], antithetic=True, seed=SEED, dtype=dt,
                      device="cpu")
    assert not lsmc.takes(paths, basis_dim)
    args = (paths, torch.as_tensor(KS, dtype=dt),
            torch.as_tensor(0.03, dtype=dt),
            torch.as_tensor(1.0 / KW["n_steps"], dtype=dt),
            np.arange(len(KS)) % 3 == 0)
    got = tam._lsmc_backward_batch(*args, basis_dim=basis_dim,
                                   return_stderr=True)
    want = tam._lsmc_backward_batch_plain(*args, basis_dim=basis_dim,
                                          return_stderr=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B, n", [(32, 128), (40, 300), (1, 1), (77, 4097), (64, 129)])
def test_stopping_date_layout_round_trips(B, n):
    """``pack_tau`` puts strike b's paths 16g … 16g + 15 in the 16-byte
    word (b // 32, g, b % 32) of the kernel's layout, and ``unpack_tau``
    takes them back."""
    from torch_lsmc_layout import pack_tau, unpack_tau

    tau = ((torch.arange(B)[:, None] * 7 + torch.arange(n)[None, :]) % 251
           ).to(torch.uint8)
    flat = pack_tau(tau, 255)
    tiles, n_pad = -(-B // 32), -(-n // 128) * 128
    assert flat.numel() == tiles * 32 * n_pad
    words = flat.view(tiles, n_pad // 16, 32, 16)
    for b, p in [(0, 0), (B - 1, n - 1), (B // 2, n // 3)]:
        assert int(words[b // 32, p // 16, b % 32, p % 16]) == int(tau[b, p])
    assert torch.equal(unpack_tau(flat, B, n), tau)
    assert int((flat == 255).sum()) == tiles * 32 * n_pad - B * n
