"""Port vs reference: the fused local-vol march (K8) and its plain version.

* Kernel operands: the reference's own f32[6] params, (1, B_pad) strike and
  sign rows and (m_pad, n_t_pad) σ table are carried across with
  ``convert.fd_lv_*`` and fed to the port's ``fd_lv`` on the CPU (its plain
  version). That holds the kernel's arithmetic apart from the evaluation of
  ``sigma_func``. The interior layers agree with
  ``_run_fd_lv(..., interpret=True)`` within rtol 2e-5 and atol 2e-5 for
  PCR and Thomas, calls and puts, with and without the American
  projection (the same f32 operations in the same order; XLA:CPU's and
  torch's exp of the two boundary constants differ by an ulp: max
  relative difference 6.7e-7 measured, 4.6e-5 absolute on far-field
  values of ~237, a few ulps there).
* With the port's own σ table (torch's exp and smile, not XLA's), the
  prices of ``fd_lv_ladder_kernel`` meet ``fd_lv_ladder_pallas``'s within
  atol 2e-4 and rtol 2e-5, the tolerance of the reference's own fused vs
  per-step test (max |price difference| 7.6e-6 measured).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models.pde import _build_grid as j_build_grid
from optpricer_tpu.ops import pallas_fd_lv as jlv
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.ops import fd_lv as tlv
from tests.torch_threads import torch_one_thread  # noqa: F401

MARKET = (100.0, 1.0, 0.04, 0.01)    # S0, T, r, q
KS = np.array([85.0, 100.0, 115.0])
GRID = dict(N_S=64, N_t=32, ref_vol=0.3)


def _jsmile(S, t):
    return 0.2 + 0.1 * jnp.exp(-((jnp.log(S / 100.0)) ** 2)) + 0.05 * t


def _tsmile(S, t):
    return 0.2 + 0.1 * torch.exp(-((torch.log(S / 100.0)) ** 2)) + 0.05 * t


def _reference_operands(kind, N_S, N_t, ref_vol, S_max_mult=4.0):
    """The operands ``fd_lv_ladder_pallas`` hands ``_run_fd_lv``
    (``pallas_fd_lv.py:297-327``), built with the JAX package."""
    S0, T, r, q = MARKET
    mask = np.broadcast_to(np.atleast_1d(kind == "call"), KS.shape)
    B = KS.size
    x_np, dx, dt = j_build_grid(S0, T, ref_vol, N_S, N_t, S_max_mult)
    m = N_S - 1
    m_pad = -(-m // jlv.GROUP) * jlv.GROUP
    b_tile = jlv.LANE
    K_pad = np.full((1, b_tile), KS[0], np.float32)
    K_pad[0, :B] = KS
    sign_pad = np.where(np.pad(mask, (0, b_tile - B), constant_values=True),
                        1.0, -1.0).astype(np.float32)[None, :]
    params = jnp.asarray([x_np[0], dx, dt, r, q, T], jnp.float32)
    n_t_pad = -(-N_t // jlv.LANE) * jlv.LANE
    S32 = jnp.exp(jnp.asarray(x_np, jnp.float32))
    t_vals = jnp.arange(N_t, dtype=jnp.float32) * jnp.asarray(dt,
                                                              jnp.float32)
    rows = jnp.stack([_jsmile(S32, t)[1:N_S] for t in t_vals])
    sig_tab = jnp.zeros((m_pad, n_t_pad), jnp.float32) \
        .at[:m, :N_t].set(rows.T)
    return params, K_pad, sign_pad, sig_tab, m, m_pad, b_tile


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("american", [False, True])
def test_plain_matches_interpret_kernel_on_its_operands(method, kind,
                                                        american):
    N_S, N_t = GRID["N_S"], GRID["N_t"]
    params, K_pad, sign_pad, sig_tab, m, m_pad, b_tile = \
        _reference_operands(kind, N_S, N_t, GRID["ref_vol"])
    ref = np.asarray(jlv._run_fd_lv(
        params, jnp.asarray(K_pad), jnp.asarray(sign_pad), sig_tab,
        n_t=N_t, m=m, m_pad=m_pad, b_tile=b_tile, n_prog=1, theta=0.5,
        american=american, interpret=True, method=method))
    got = tlv.fd_lv(convert.fd_lv_params(np.asarray(params)),
                    convert.fd_lv_lanes(K_pad),
                    convert.fd_lv_lanes(sign_pad),
                    convert.fd_lv_sigma_table(np.asarray(sig_tab), N_t),
                    n_t=N_t, m=m, m_pad=m_pad, theta=0.5, american=american,
                    method=method)
    assert got.shape == ref.shape == (m_pad, b_tile)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("kind, american", [("call", False), ("put", True)])
def test_ladder_matches_reference_ladder(method, kind, american):
    S0, T, r, q = MARKET
    args = (S0, KS, T, r, q)
    got = tlv.fd_lv_ladder_kernel(*args, _tsmile, kind, american=american,
                                  method=method, device="cpu", **GRID)
    ref = jlv.fd_lv_ladder_pallas(*args, _jsmile, kind, american=american,
                                  method=method, interpret=True, **GRID)
    assert isinstance(got, np.ndarray) and got.shape == KS.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-5)


def test_fused_solvers_of_the_batch_entry_point():
    """``solver="fused"`` / ``"fused_pcr"`` / ``"fused_thomas"`` agree with
    one another and with the per-step f64 march (the reference's own
    tolerance, ``tests/test_pallas_tridiag.py:124``)."""
    S0, T, r, q = MARKET
    args = (S0, KS, T, r, q, _tsmile, "call")
    per_step = tp.fd_price_local_vol_batch(*args, solver="pallas",
                                           device="cpu", **GRID).numpy()
    for solver in ("fused", "fused_pcr", "fused_thomas"):
        fused = tp.fd_price_local_vol_batch(*args, solver=solver,
                                            device="cpu", **GRID)
        np.testing.assert_allclose(fused, per_step, atol=2e-4, rtol=2e-5)


def test_ragged_put_ladder_matches_per_step_prices():
    Ks = np.linspace(90.0, 120.0, 5)
    fused = tp.fd_price_local_vol_batch(100.0, Ks, 0.5, 0.03, 0.0, _tsmile,
                                        "put", solver="fused", N_S=64,
                                        N_t=32, ref_vol=0.3, device="cpu")
    for k, got in zip(Ks, fused):
        ref = tp.fd_price_local_vol(100.0, float(k), 0.5, 0.03, 0.0, _tsmile,
                                    "put", N_S=64, N_t=32, ref_vol=0.3,
                                    device="cpu")
        assert abs(got - ref) < 2e-3, (k, got, ref)


def test_sigma_table_layout():
    """The port's table is the reference's transposed: row n is the σ
    column of step n, zero beyond the m interior rows."""
    N_S, N_t = 40, 12
    params, K_pad, sign_pad, sig_tab, m, m_pad, _ = _reference_operands(
        "call", N_S, N_t, 0.3)
    x_np, dx, dt = j_build_grid(MARKET[0], MARKET[1], 0.3, N_S, N_t, 4.0)
    ours = tlv._sigma_table(_tsmile, x_np, dt, N_S, N_t, m_pad, "cpu")
    theirs = convert.fd_lv_sigma_table(np.asarray(sig_tab), N_t)
    assert ours.shape == theirs.shape == (N_t, m_pad)
    assert not ours[:, m:].any()
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-6,
                               atol=0.0)


def test_operand_checks():
    with pytest.raises(ValueError):
        convert.fd_lv_params(np.zeros(5, np.float32))
    with pytest.raises(ValueError):
        convert.fd_lv_lanes(np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        convert.fd_lv_sigma_table(np.zeros((8, 4), np.float32), 6)
    p = torch.zeros(6)
    k = torch.ones(3)
    tab = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tlv.fd_lv(p, k, k, tab, n_t=4, m=7, m_pad=8, theta=0.5,
                  american=False, method="lu")
    with pytest.raises(ValueError):
        tlv.fd_lv(p, k, k, tab.double(), n_t=4, m=7, m_pad=8, theta=0.5,
                  american=False)
    with pytest.raises(ValueError):
        tlv.fd_lv(p, k, k, torch.zeros(4, 1032), n_t=4, m=1031,
                  m_pad=1032, theta=0.5, american=False, method="pcr")
