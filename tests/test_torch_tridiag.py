"""Port vs reference: the tridiagonal solvers and K7's plain version.

* ``tridiag_solve`` (log-depth: the port's doubling scans against XLA's
  associative scans), ``tridiag_solve_thomas`` (the port keeps K7's
  two-division arithmetic, the reference its pivot form), ``tridiag_matvec``
  and ``tridiag_dense`` agree with the JAX functions to rtol 1e-10 in f64
  on diagonally dominant systems made from a numpy seed.
* K7's plain version (``ops/thomas._thomas_plain``, the (n, batch) layout)
  and its last-axis adapter agree with the Pallas kernel run in interpret
  mode, ``tridiag_solve_pallas(interpret=True)``, to rtol 1e-9: the same
  elimination in the same order, so only XLA:CPU's and torch's rounding of
  the same operations differ.
* ``a[0]`` and ``c[n−1]`` are never read.
* The plain mirror of K7's own arithmetic (``ops/thomas._pcr_plain``:
  diagonal-normalised parallel cyclic reduction, and above
  ``PCR_MAX_ROWS`` rows the partitioned form) against the interpreted
  Pallas kernel and against ``_thomas_plain``, on θ-scheme systems built
  as ``models/pde.py`` builds them (with knocked-out identity rows) and on
  random diagonally dominant ones, for n from 1 to a partitioned size and
  batch 1, 3 and 128: rtol 1e-12 in f64 and 2e-5 in f32, each with an
  absolute floor of rtol·max|x| (the two eliminations round differently,
  so an entry far below the solution's scale is held to the scale).
* The last-axis adapter hands the launcher views of the caller's tensors:
  no transposed copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import pallas_tridiag as jpt
from optpricer_tpu.ops import tridiag as jtd
from optpricer_tpu_torch.ops import thomas as tth
from optpricer_tpu_torch.ops import tridiag as ttd
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-10
SHAPES = [(37,), (3, 37), (5, 2, 21)]


def _system(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape)
    b = rng.normal(size=shape) + 4.0
    c = rng.normal(size=shape)
    d = rng.normal(size=shape)
    return a, b, c, d


def _pair(arrays):
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(x.copy()) for x in arrays])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn", ["tridiag_solve", "tridiag_solve_thomas"])
def test_solvers_match_reference(shape, fn):
    j, t = _pair(_system(shape, seed=len(shape)))
    ref = np.asarray(getattr(jtd, fn)(*j))
    got = getattr(ttd, fn)(*t).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_matvec_matches_reference(shape):
    j, t = _pair(_system(shape, seed=7))
    np.testing.assert_allclose(ttd.tridiag_matvec(*t).numpy(),
                               np.asarray(jtd.tridiag_matvec(*j)),
                               rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_dense_matches_reference(shape):
    j, t = _pair(_system(shape, seed=9)[:3])
    dense = ttd.tridiag_dense(*t)
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jtd.tridiag_dense(*j)))
    # the dense matrix times the solution gives back the rhs
    a, b, c, d = (torch.from_numpy(x) for x in _system(shape, seed=9))
    x = ttd.tridiag_solve(a, b, c, d)
    np.testing.assert_allclose((dense @ x[..., None])[..., 0].numpy(),
                               d.numpy(), rtol=0, atol=1e-12)


def test_solve_broadcasts_row_coefficients():
    """One coefficient row for every system, as the PDE stack passes it."""
    a, b, c, d = _system((3, 37), seed=2)
    a, b, c = a[0], b[0], c[0]
    ref = np.asarray(jtd.tridiag_solve(
        *(jnp.broadcast_to(jnp.asarray(x), d.shape) for x in (a, b, c)),
        jnp.asarray(d)))
    t = [torch.from_numpy(x.copy()) for x in (a, b, c, d)]
    for fn in (ttd.tridiag_solve, ttd.tridiag_solve_thomas):
        np.testing.assert_allclose(fn(*t).numpy(), ref, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("n, batch, seed", [(64, 128, 0), (32, 256, 3)])
def test_kernel_plain_matches_pallas_interpret(n, batch, seed):
    j, t = _pair(_system((n, batch), seed=seed))
    ref = np.asarray(jpt.tridiag_solve_pallas(*j, interpret=True))
    got = tth.tridiag_solve_kernel(*t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
def test_lastdim_adapter_matches_pallas_interpret(shape):
    j, t = _pair(_system(shape, seed=7 + len(shape)))
    ref = np.asarray(jpt.tridiag_solve_pallas_lastdim(*j, interpret=True))
    got = tth.tridiag_solve_kernel_lastdim(*t)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-10)


def test_unused_corners_are_never_read():
    """Garbage in a[0] and c[n−1] (the PDE stack broadcasts its
    coefficients over every row, so c[n−1] ≠ 0 there) changes nothing."""
    a, b, c, d = _system((21, 6), seed=4)
    clean = [x.copy() for x in (a, b, c, d)]
    clean[0][0] = 0.0
    clean[2][-1] = 0.0
    dirty = [x.copy() for x in (a, b, c, d)]
    dirty[0][0] = 1e30
    dirty[2][-1] = np.nan
    want = tth.tridiag_solve_kernel(*(torch.from_numpy(x) for x in clean))
    got = tth.tridiag_solve_kernel(*(torch.from_numpy(x) for x in dirty))
    assert torch.equal(got, want)
    # the same through the last-axis layout and the Thomas entry point
    got_last = ttd.tridiag_solve_thomas(
        *(torch.from_numpy(np.ascontiguousarray(x.T)) for x in dirty))
    np.testing.assert_array_equal(got_last.numpy().T, want.numpy())


def test_unused_corners_match_pallas_interpret():
    """The Pallas kernel masks the same two corners (unpadded n here)."""
    a, b, c, d = _system((24, 128), seed=6)
    a[0] = 1e30
    c[-1] = -1e30
    j, t = _pair((a, b, c, d))
    ref = np.asarray(jpt.tridiag_solve_pallas(*j, interpret=True))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(tth.tridiag_solve_kernel(*t).numpy(), ref,
                               rtol=1e-9, atol=1e-10)


def test_kernel_takes_shared_columns():
    """(n, 1) coefficient columns solve as their (n, batch) broadcast."""
    a, b, c, d = _system((17, 5), seed=5)
    cols = [torch.from_numpy(x[:, :1].copy()) for x in (a, b, c)]
    full = [col.expand(17, 5).contiguous() for col in cols]
    dt = torch.from_numpy(d)
    assert torch.equal(tth.tridiag_solve_kernel(*cols, dt),
                       tth.tridiag_solve_kernel(*full, dt))


def test_kernel_checks_its_operands():
    a, b, c, d = (torch.from_numpy(x) for x in _system((8, 4)))
    with pytest.raises(ValueError):
        tth.tridiag_solve_kernel(a[:, :3].contiguous(), b, c, d)
    with pytest.raises(ValueError):
        tth.tridiag_solve_kernel(a.float(), b, c, d)
    with pytest.raises(ValueError):
        tth.tridiag_solve_kernel(a, b, c, d.t())


def test_float32_thomas_matches_reference():
    j, t = _pair([x.astype(np.float32) for x in _system((3, 37), seed=8)])
    np.testing.assert_allclose(ttd.tridiag_solve_thomas(*t).numpy(),
                               np.asarray(jtd.tridiag_solve_thomas(*j)),
                               rtol=2e-6, atol=1e-6)


# -- K7's algorithm: the plain mirror of the CUDA kernel --------------------
# above PCR_MAX_ROWS the partitioned form: 1025 and 1536 in chunks of 3
# rows (no up-sweep), 2049 in chunks of 5
PCR_NS = [1, 2, 3, 37, 199, 511, 1025, 1536, 2049]
PCR_RTOL = {np.float64: 1e-12, np.float32: 2e-5}


def _theta_system(n, batch, seed, dtype):
    """(n, batch) implicit θ = ½ systems of the log-spot PDE as
    ``models/pde._fd_solve`` builds them: a local-vol σ per row and system,
    rows above a barrier knocked out into identity rows in every other
    system, finite garbage in a[0] and c[n−1], and a payoff-like rhs."""
    rng = np.random.default_rng(seed)
    x = np.linspace(np.log(100.0) - 1.5, np.log(100.0) + 1.5, n + 2)[1:-1]
    dx, dt, r, q = 3.0 / (n + 1), 1.0 / 256, 0.04, 0.01
    sig = 0.2 + 0.1 * np.exp(-(x[:, None] - np.log(100.0)) ** 2) \
        + 0.05 * rng.uniform(size=(n, batch))
    alpha = 0.5 * sig ** 2 / dx ** 2
    beta = (r - q - 0.5 * sig ** 2) / (2.0 * dx)
    a_L, b_L, c_L = alpha - beta, -2.0 * alpha - r, alpha + beta
    knocked = (np.exp(x)[:, None] >= 130.0) & (np.arange(batch) % 2 == 0)
    a_L, b_L, c_L = (np.where(knocked, 0.0, t) for t in (a_L, b_L, c_L))
    a = -0.5 * dt * a_L
    b = 1.0 - 0.5 * dt * b_L
    c = -0.5 * dt * c_L
    d = np.maximum(np.exp(x)[:, None] - rng.uniform(80.0, 120.0, batch), 0.0)
    d = np.where(knocked, 0.0, d + rng.normal(size=(n, batch)))
    a[0] = 1e30
    c[-1] = -1e30
    return [t.astype(dtype) for t in (a, b, c, d)]


def _assert_close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch", [1, 3, 128])
@pytest.mark.parametrize("n", PCR_NS)
def test_pcr_mirror_matches_pallas_interpret_on_theta_systems(n, batch,
                                                              dtype):
    arrays = _theta_system(n, batch, seed=n + batch, dtype=dtype)
    j, t = _pair(arrays)
    # the reference's last-axis adapter pads to its 8 x 128 tiles
    ref = np.asarray(jpt.tridiag_solve_pallas_lastdim(
        *(x.T for x in j), interpret=True)).T
    got = tth._pcr_plain(*t).numpy()
    assert got.dtype == dtype and np.isfinite(got).all()
    _assert_close(got, ref, PCR_RTOL[dtype])
    _assert_close(got, tth._thomas_plain(*t).numpy(), PCR_RTOL[dtype])


@pytest.mark.parametrize("n", PCR_NS)
def test_pcr_mirror_matches_thomas_on_random_systems(n):
    a, b, c, d = _system((n, 3), seed=n)
    a[0] = 1e30
    c[-1] = np.nan
    t = [torch.from_numpy(x) for x in (a, b, c, d)]
    got = tth._pcr_plain(*t).numpy()
    _assert_close(got, tth._thomas_plain(*t).numpy(), 1e-12)
    # NaN in the unused corners reaches neither version
    a[0] = c[-1] = 0.0
    clean = tth._pcr_plain(*(torch.from_numpy(x) for x in (a, b, c, d)))
    assert torch.equal(torch.from_numpy(got), clean)


def test_pcr_mirror_takes_shared_columns():
    """One coefficient column for every system, as the propagator build
    and the ladder pass it, solves as its broadcast."""
    a, b, c, d = _theta_system(2049, 4, seed=3, dtype=np.float64)
    cols = [torch.from_numpy(x[:, :1].copy()) for x in (a, b, c)]
    dt = torch.from_numpy(d)
    got = tth._pcr_plain(*cols, dt)
    assert torch.equal(got, tth._pcr_plain(
        *(col.expand(2049, 4) for col in cols), dt))
    _assert_close(got.numpy(), tth._thomas_plain(*cols, dt).numpy(), 1e-12)


def test_lastdim_hands_the_launcher_views(monkeypatch):
    """(..., n) operands reach the launcher as (n, outer, inner) views of
    the caller's storage, and the solution is written where the caller gets
    it: no transposed copy on the way in or out."""
    a, b, c, d = (torch.from_numpy(x) for x in _system((5, 2, 21), seed=4))
    rows = [t[0, 0] for t in (a, b)]
    seen = []
    solve_into = tth._solve_into

    def recording(A, B, C, D, X):
        seen.append((A, B, C, D, X))
        solve_into(A, B, C, D, X)

    monkeypatch.setattr(tth, "_solve_into", recording)
    x = tth.tridiag_solve_kernel_lastdim(*rows, c, d)
    (A, B, C, D, X), = seen
    for view, caller in ((A, a), (B, b), (C, c), (D, d), (X, x)):
        assert view.shape == (21, 5, 2)
        assert view.untyped_storage().data_ptr() == \
            caller.untyped_storage().data_ptr()
    assert A.stride() == (1, 0, 0) and D.stride() == (1, 42, 21)
    ref = tth._thomas_plain(*(t.expand(5, 2, 21).reshape(10, 21).t()
                              for t in (*rows, c, d)))
    assert torch.equal(x, ref.t().reshape(5, 2, 21))


def test_tridiag_inv_hands_the_launcher_bands_and_one_identity(monkeypatch):
    """tridiag_inv's systems (matrix, unit vector) reach the launcher as
    views: each matrix's bands with a stride of 0 along the unit vectors,
    one (n, n) identity with a stride of 0 along the matrices, and the
    inverse's transpose written in place; the result equals the plain
    solve of the expanded systems."""
    lo, mid, hi, _ = (torch.from_numpy(x) for x in _system((3, 11), seed=5))
    seen = []
    solve_into = tth._solve_into

    def recording(A, B, C, D, X):
        seen.append((A, B, C, D, X))
        solve_into(A, B, C, D, X)

    monkeypatch.setattr(tth, "_solve_into", recording)
    inv = ttd.tridiag_inv(lo, mid, hi, newton=False)
    (A, B, C, D, X), = seen
    for view, band in ((A, lo), (B, mid), (C, hi)):
        assert view.shape == (11, 3, 11) and view.stride() == (1, 11, 0)
        assert view.data_ptr() == band.data_ptr()
    assert D.shape == (11, 3, 11) and D.stride() == (1, 0, 11)
    assert X.stride() == (1, 121, 11)
    assert X.data_ptr() == inv.data_ptr()
    eye = torch.eye(11, dtype=torch.float64)
    ref = tth._thomas_plain(*(t.reshape(3, 1, 11).expand(3, 11, 11)
                              .reshape(33, 11).t() for t in (lo, mid, hi)),
                            eye.expand(3, 11, 11).reshape(33, 11).t())
    assert torch.equal(inv.transpose(-1, -2), ref.t().reshape(3, 11, 11))
