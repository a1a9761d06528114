"""Path-dependent multi-asset Monte-Carlo sufficient statistics: the basket
kernel (K6).

Counterpart of ``optpricer_tpu/ops/pallas_basket_mc.py``. Each path pair
carries the spots of up to ``MAX_ASSETS`` correlated GBM assets (exact
log-Euler, the Cholesky factor applied as a lower-triangular chain), the
running basket sum and the barrier flag through ``n_steps`` steps, and
reduces its discounted payoff and the control Y = e^{−rT}·B_T to the 6
control-variate sums (n, ΣX, ΣX², ΣY, ΣY², ΣXY); nothing path-shaped
reaches device memory. Payoffs: ``asian_basket`` (t = 0 excluded from the
average), ``worstof_barrier`` and ``basket_barrier`` (t = 0 included
through the host's ``crossed0`` flag), up/down × in/out with a rebate;
antithetic pairs are averaged into one observation, so ``n_paths`` counts
pairs. The draws are the JAX kernel's ``sw_prng`` stream: Threefry keyed by
(seed, global program id) with counter (element, (c·n_steps + t)·⌈a/2⌉ +
k), so a seed gives the reference's sample and the sums agree with it to
f32 round-off.

Names, JAX → port:

================================  ================================
``basket_path_sumstats_pallas``   ``basket_path_sumstats_kernel``
``basket_path_sumstats_pallas_sharded``  ``basket_path_sumstats_kernel_sharded``
``_run_basket_kernel``            ``basket_mc`` (kernel wrapper)
``_build_params``                 ``_build_params``
================================  ================================

``basket_mc`` launches ``basket_mc_kernel`` (``csrc/basket_mc.cu``) for
tensors on a CUDA device and counts the launch in ``basket_mc.launches``;
for tensors on the CPU it runs the plain torch version ``_basket_mc_plain``,
which walks all programs and reps of the grid at once, one step at a time.
Any other device raises. The kernel takes its constants in a
kernel-parameter struct that ``_pack_params`` packs from the host copy of
``params`` (the public entry builds it there, so the main path copies
nothing back from the card); its grid is ``_launch_plan``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..dtypes import MC_DTYPE, resolve_device
from . import stats as stats_ops
from .fastmath import exp32, log32
from .path_mc import _sqrt32
from .swprng import threefry2x32
from .terminal_mc import (_MAX_TILE_INDEX, _plan_grid, _seed_pair,
                          _shard_plan, _stream)

__all__ = ["basket_path_sumstats_kernel",
           "basket_path_sumstats_kernel_sharded", "basket_mc",
           "blocks_per_sm",
           "TILE", "NSTAT", "PAYOFF_IDS", "MAX_ASSETS"]

BLOCK_R = 32
LANES = 128
TILE = BLOCK_R * LANES   # path pairs per rep (4096)
NSTAT = 6                # (n, ΣX, ΣX², ΣY, ΣY², ΣXY)
MAX_ASSETS = 16          # csrc/basket_mc.cu MAX_ASSETS

PAYOFF_IDS = {"asian_basket": 0, "worstof_barrier": 1, "basket_barrier": 2}

# params layout: 7 scalars, then (S0_i, drift_i, voldt_i, w_i) per asset,
# then the Cholesky factor row-major
_P_K, _P_DF, _P_NPATHS, _P_SIGN, _P_BARRIER, _P_REBATE, _P_CROSSED0 = \
    range(7)
_P_ASSETS = 7

_ROW = 8                 # kernel stats rows are padded to 8 floats
_THREADS = 128           # csrc/basket_mc.cu THREADS
_BLOCKS_PER_PROGRAM = TILE // _THREADS
_TINY = 2.0 ** -24
_TWO_PI = float(np.float32(6.283185307179586))
_FLAG_BITS = {"barrier_up": 1, "knock_in": 2}
# csrc/basket_mc.cu BasketParams: the 7 scalars of params and a pad word,
# then S0, drift, voldt and w of MAX_ASSETS assets each, then the lower
# triangle of the Cholesky factor, row i at i(i+1)/2
_STRUCT_SCALARS = 8
_STRUCT_FIELDS = ("S0", "drift", "voldt", "w")
_STRUCT_CHOL = _STRUCT_SCALARS + len(_STRUCT_FIELDS) * MAX_ASSETS
_STRUCT_WORDS = _STRUCT_CHOL + MAX_ASSETS * (MAX_ASSETS + 1) // 2


def _n_params(n_assets: int) -> int:
    return _P_ASSETS + 4 * n_assets + n_assets * n_assets


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------
def _build_params(n_paths, n_steps, S0s, w, K, T, r, qs, sigmas, chol,
                  barrier, rebate, is_call, payoff, barrier_up
                  ) -> torch.Tensor:
    """Host f32[7 + 4a + a²]: K, e^{−rT}, n_paths, sign, barrier, rebate,
    crossed0, then per asset S0, (r−q−σ²/2)dt, σ√dt, w, then the Cholesky
    factor row-major. ``crossed0`` resolves the t = 0 monitoring date."""
    a = len(S0s)
    dt = T / n_steps
    sign = 1.0 if is_call else -1.0
    B0 = float(np.dot(S0s, w))
    lvl0 = B0 if payoff == "basket_barrier" else float(np.min(S0s))
    if payoff == "asian_basket":
        crossed0 = 0.0
    else:
        crossed0 = float((lvl0 >= barrier) if barrier_up
                         else (lvl0 <= barrier))
    vals = [K, np.exp(-r * T), float(n_paths), sign, barrier, rebate,
            crossed0]
    for i in range(a):
        vals += [S0s[i], (r - qs[i] - 0.5 * sigmas[i] ** 2) * dt,
                 sigmas[i] * np.sqrt(dt), w[i]]
    vals += list(np.asarray(chol, np.float64).reshape(-1))
    return torch.tensor(np.asarray(vals, np.float64), dtype=MC_DTYPE)


def _pack_params(host_params: torch.Tensor, n_assets: int) -> np.ndarray:
    """f32[_STRUCT_WORDS]: the kernel-parameter struct ``BasketParams`` of
    ``csrc/basket_mc.cu`` from the host f32 params of ``_build_params``
    (the same f32 values, moved: asset i's S0, drift, voldt and w to slot i
    of their field, the factor's lower triangle row by row); unused slots
    are 0."""
    a = n_assets
    v = host_params.numpy()
    out = np.zeros(_STRUCT_WORDS, np.float32)
    out[:_P_ASSETS] = v[:_P_ASSETS]
    per_asset = v[_P_ASSETS:_P_ASSETS + 4 * a].reshape(a, 4)
    for f in range(len(_STRUCT_FIELDS)):
        lo = _STRUCT_SCALARS + f * MAX_ASSETS
        out[lo:lo + a] = per_asset[:, f]
    chol = v[_P_ASSETS + 4 * a:].reshape(a, a)
    out[_STRUCT_CHOL:_STRUCT_CHOL + a * (a + 1) // 2] = \
        chol[np.tril_indices(a)]
    return out


def _launch_plan(n_programs: int, reps: int):
    """(blocks, rows per program) of ``basket_mc_kernel``'s grid, as
    ``optpricer_basket_mc`` launches it: a block of 128 path pairs per
    (program, rep, block in tile), block index (program·reps + rep)·32 +
    block. Each block writes one stats row; the first combine pass
    Kahan-sums a program's rows in (rep, block) order."""
    rows = reps * _BLOCKS_PER_PROGRAM
    return n_programs * rows, rows


def _check_inputs(seed, params, n_programs, reps, n_assets, n_steps,
                  payoff_id):
    if n_programs < 1 or reps < 1:
        raise ValueError(f"empty grid: n_programs={n_programs}, reps={reps} "
                         "(n_paths must be positive)")
    if not 1 <= n_assets <= MAX_ASSETS:
        raise ValueError(f"the basket kernel takes 1 to MAX_ASSETS = "
                         f"{MAX_ASSETS} assets, got {n_assets}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be positive, got {n_steps}")
    if n_programs * reps >= _MAX_TILE_INDEX:
        raise ValueError("n_paths must stay below 2**24 tiles of TILE pairs")
    if reps * n_steps * ((n_assets + 1) // 2) >= 2 ** 31:
        raise ValueError("reps * n_steps * ceil(n_assets / 2) draws must "
                         "stay below 2**31")
    if payoff_id not in PAYOFF_IDS.values():
        raise ValueError(f"unknown payoff id {payoff_id}")
    if seed.dtype != torch.int32 or seed.shape != (2,):
        raise ValueError("seed must be an int32 tensor of shape (2,)")
    if params.dtype != MC_DTYPE or params.shape != (_n_params(n_assets),):
        raise ValueError(f"params must be a float32 tensor of shape "
                         f"({_n_params(n_assets)},) for {n_assets} assets")
    if not (seed.is_contiguous() and params.is_contiguous()):
        raise ValueError("seed and params must be contiguous")
    if seed.device != params.device:
        raise ValueError(f"seed on {seed.device}, params on {params.device}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")


# ---------------------------------------------------------------------------
# plain torch version (the CPU path and the kernel's on-card reference)
# ---------------------------------------------------------------------------
def _basket_mc_plain(seed, params, *, n_programs: int, reps: int,
                     n_assets: int, n_steps: int, antithetic: bool,
                     payoff_id: int, barrier_up: bool,
                     knock_in: bool) -> torch.Tensor:
    """Plain version of ``basket_mc``: every (program, rep, element) path
    pair at once as (n_programs, reps, TILE) tensors, one step at a time;
    tile sums, Kahan over reps, then the programs combined in order. Each
    operation rounds as the kernel's does: the square root through float64
    (torch's CPU f32 ``sqrt`` is not always correctly rounded) and the
    Asian average divided by a 0-d tensor (on the card a division by a
    Python number is a multiplication by its reciprocal)."""
    dev = params.device
    a = n_assets
    key0, offset = (int(v) for v in seed.tolist())
    K, df, n_paths, sign, barrier, rebate, crossed0 = (params[i]
                                                       for i in range(7))
    S0 = [params[_P_ASSETS + 4 * i] for i in range(a)]
    drift = [params[_P_ASSETS + 4 * i + 1] for i in range(a)]
    voldt = [params[_P_ASSETS + 4 * i + 2] for i in range(a)]
    w = [params[_P_ASSETS + 4 * i + 3] for i in range(a)]
    chol0 = _P_ASSETS + 4 * a
    L = [[params[chol0 + i * a + j] for j in range(i + 1)] for i in range(a)]
    n_pairs = (a + 1) // 2
    shape = (n_programs, reps, TILE)
    pid = (offset + torch.arange(n_programs, dtype=torch.int64,
                                 device=dev)).view(-1, 1, 1)
    rep = torch.arange(reps, dtype=torch.int64, device=dev).view(1, -1, 1)
    elem = torch.arange(TILE, dtype=torch.int64, device=dev).view(1, 1, -1)
    nsf = torch.tensor(float(n_steps), dtype=MC_DTYPE, device=dev)

    def normals(draw):
        bits_a, bits_b = threefry2x32(key0, pid, elem, draw)
        u1 = ((bits_a >> 8).to(MC_DTYPE) + 0.5) * _TINY
        u2 = (bits_b >> 8).to(MC_DTYPE) * _TINY
        rad = _sqrt32(-2.0 * log32(u1))
        theta = _TWO_PI * u2
        return rad * torch.cos(theta), rad * torch.sin(theta)

    def basket(S):
        B = w[0] * S[0]
        for i in range(1, a):
            B = B + w[i] * S[i]
        return B

    def worst(S):
        m = S[0]
        for i in range(1, a):
            m = torch.minimum(m, S[i])
        return m

    def init_leg():
        return ([S0[i].expand(shape) for i in range(a)],
                torch.zeros(shape, dtype=MC_DTYPE, device=dev),
                crossed0.expand(shape))

    def advance(leg, xs):
        S, run_sum, crossed = leg
        S = [S[i] * exp32(drift[i] + voldt[i] * xs[i]) for i in range(a)]
        B = basket(S)
        if payoff_id == PAYOFF_IDS["asian_basket"]:
            run_sum = run_sum + B
        else:
            lvl = worst(S) if payoff_id == PAYOFF_IDS["worstof_barrier"] \
                else B
            hit = (lvl >= barrier) if barrier_up else (lvl <= barrier)
            crossed = torch.maximum(crossed, hit.to(MC_DTYPE))
        return S, run_sum, crossed

    def payoff_of(leg):
        S, run_sum, crossed = leg
        B_T = basket(S)
        if payoff_id == PAYOFF_IDS["asian_basket"]:
            pay = torch.clamp(sign * (run_sum / nsf - K), min=0.0)
        else:
            term = worst(S) if payoff_id == PAYOFF_IDS["worstof_barrier"] \
                else B_T
            live = torch.clamp(sign * (term - K), min=0.0)
            hit = crossed > 0.5
            pay = torch.where(hit, live, rebate) if knock_in \
                else torch.where(hit, rebate, live)
        return df * pay, df * B_T

    leg_p, leg_m = init_leg(), init_leg()
    for t in range(n_steps):
        d0 = (rep * n_steps + t) * n_pairs
        zs = []
        for k in range(n_pairs):
            zs += list(normals(d0 + k))
        # correlate: x_i = Σ_{j≤i} L_ij z_j (the mirrored leg's shocks are
        # exactly −x_i: negation commutes with every rounding)
        xs = []
        for i in range(a):
            x = L[i][0] * zs[0]
            for j in range(1, i + 1):
                x = x + L[i][j] * zs[j]
            xs.append(x)
        leg_p = advance(leg_p, xs)
        if antithetic:
            leg_m = advance(leg_m, [-x for x in xs])

    X, Y = payoff_of(leg_p)
    if antithetic:
        Xm, Ym = payoff_of(leg_m)
        X = 0.5 * (X + Xm)
        Y = 0.5 * (Y + Ym)
    # tail mask by the per-tile remainder, in f32 as on the TPU
    prog_offset = (pid.to(MC_DTYPE) * reps + rep.to(MC_DTYPE)) * TILE
    wgt = (elem.to(MC_DTYPE) < n_paths - prog_offset).to(MC_DTYPE)
    wgt = wgt.expand(shape)
    WX, WY = X * wgt, Y * wgt
    s = torch.stack([t.sum(dim=-1) for t in (wgt, WX, WX * X, WY, WY * Y,
                                              WX * Y)], dim=-1)
    acc = torch.zeros((n_programs, NSTAT), dtype=MC_DTYPE, device=dev)
    comp = torch.zeros_like(acc)
    for c in range(reps):
        acc, comp = stats_ops.kahan_add(acc, comp, s[:, c])
    return stats_ops.combine_scan(acc)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def blocks_per_sm(n_assets: int, payoff_id: int, antithetic: bool) -> int:
    """Resident blocks per SM of the instantiation ``basket_mc`` launches
    for these arguments (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    on the current card)."""
    import ctypes

    lib = _build.load()
    n = ctypes.c_int(0)
    err = lib.optpricer_basket_mc_occupancy(
        int(n_assets), int(payoff_id), int(bool(antithetic)),
        ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"basket_mc_kernel occupancy query failed: CUDA "
                           f"error {err}")
    return n.value


def basket_mc(seed: torch.Tensor, params: torch.Tensor, *, n_programs: int,
              reps: int, n_assets: int, n_steps: int, antithetic: bool,
              payoff_id: int, barrier_up: bool, knock_in: bool,
              host_params: torch.Tensor | None = None) -> torch.Tensor:
    """f32[6] basket path sums over the (n_programs, reps) grid.

    Kernel ``basket_mc_kernel`` in ``csrc/basket_mc.cu``; it replaces
    ``optpricer_tpu/ops/pallas_basket_mc.py:_basket_kernel`` (launched from
    ``_run_basket_kernel``). One thread owns one (program, rep, element)
    path pair with every asset's spot for both legs in registers
    (``_launch_plan``), under an instantiation for exactly ``n_assets``
    assets; it is bound by integer and SFU issue (⌈a/2⌉ Threefry blocks
    and Box-Muller pairs a step, a exp32 per leg) and by the a(a+1)/2
    multiply-adds of the correlation chain, whose factor and per-asset
    scalars come from the constant bank, a kernel-parameter struct.
    ``host_params``: ``params``' values in host memory, from which that
    struct is packed; when not given they are copied from ``params``.
    """
    _check_inputs(seed, params, n_programs, reps, n_assets, n_steps,
                  payoff_id)
    kw = dict(n_programs=n_programs, reps=reps, n_assets=n_assets,
              n_steps=n_steps, antithetic=antithetic, payoff_id=payoff_id,
              barrier_up=barrier_up, knock_in=knock_in)
    if params.device.type == "cpu":
        return _basket_mc_plain(seed, params, **kw)
    dev = params.device
    if host_params is None:
        host_params = params.cpu()
    if host_params.device.type != "cpu" or host_params.dtype != MC_DTYPE \
            or host_params.shape != params.shape:
        raise ValueError("host_params must be params' float32 values on the "
                         "host")
    struct = _pack_params(host_params.contiguous(), n_assets)
    flags = sum(bit for name, bit in _FLAG_BITS.items() if kw[name])
    blocks, _ = _launch_plan(n_programs, reps)
    block_rows = torch.empty((blocks, _ROW), dtype=MC_DTYPE, device=dev)
    prog_rows = torch.empty((n_programs, _ROW), dtype=MC_DTYPE, device=dev)
    out = torch.empty((_ROW,), dtype=MC_DTYPE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_basket_mc(
            seed.data_ptr(), struct.ctypes.data, block_rows.data_ptr(),
            prog_rows.data_ptr(), out.data_ptr(), n_programs, reps,
            n_assets, n_steps, int(payoff_id), flags, int(bool(antithetic)),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"basket_mc_kernel launch failed: CUDA error "
                           f"{err}")
    basket_mc.launches += 1
    return out[:NSTAT]


basket_mc.launches = 0


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------
def _entry_config(n_paths, n_steps, S0s, weights, K, T, r, qs, sigmas, chol,
                  is_call, payoff, barrier, barrier_type, rebate):
    """(host params, static kwargs of ``basket_mc``) of the public
    entries, with the reference's checks."""
    if payoff not in PAYOFF_IDS:
        raise ValueError(f"payoff must be one of {tuple(PAYOFF_IDS)}")
    S0s = [float(v) for v in np.atleast_1d(S0s)]
    a = len(S0s)
    weights = [float(v) for v in np.atleast_1d(weights)]
    qs = [0.0] * a if qs is None else [float(v) for v in np.atleast_1d(qs)]
    sigmas = [float(v) for v in np.atleast_1d(sigmas)]
    if not (len(weights) == len(qs) == len(sigmas) == a):
        raise ValueError("S0s, weights, qs, sigmas must share length")
    barrier_up = barrier_type.startswith("up")
    params = _build_params(n_paths, n_steps, S0s, weights, K, T, r, qs,
                           sigmas, chol, barrier, rebate, is_call, payoff,
                           barrier_up)
    return params, dict(n_assets=a, n_steps=int(n_steps),
                        payoff_id=PAYOFF_IDS[payoff], barrier_up=barrier_up,
                        knock_in=barrier_type.endswith("in"))


def basket_path_sumstats_kernel(
    seed: int, n_paths: int, n_steps: int, S0s, weights, K, T, r, qs,
    sigmas, chol, is_call: bool, *, payoff: str, antithetic: bool = True,
    barrier: float = 0.0, barrier_type: str = "down-and-in",
    rebate: float = 0.0, device=None,
) -> torch.Tensor:
    """(6,) f32 control-variate sums for a path-dependent basket payoff.

    ``n_paths`` counts antithetic PAIRS when ``antithetic=True`` (each
    pair-averaged observation is one sample). ``chol`` is the (a, a)
    Cholesky factor of the correlation matrix.
    """
    params, static = _entry_config(n_paths, n_steps, S0s, weights, K, T, r,
                                   qs, sigmas, chol, is_call, payoff,
                                   barrier, barrier_type, rebate)
    dev = resolve_device(device)
    reps, n_programs = _plan_grid(int(n_paths), TILE)
    return basket_mc(_seed_pair(seed, dev), params.to(dev),
                     n_programs=n_programs, reps=reps,
                     antithetic=bool(antithetic), host_params=params,
                     **static)


def basket_path_sumstats_kernel_sharded(
    mesh, seed: int, n_paths: int, n_steps: int, S0s, weights, K, T, r, qs,
    sigmas, chol, is_call: bool, *, payoff: str, antithetic: bool = True,
    barrier: float = 0.0, barrier_type: str = "down-and-in",
    rebate: float = 0.0,
) -> torch.Tensor:
    """(6,) f32 sums of one global grid split over ``mesh``, the
    counterpart of ``basket_path_sumstats_pallas_sharded``: each device
    runs ``basket_mc`` over its contiguous slice of the programs (offset
    in the second seed word), every shard is launched before any is
    waited for, and the sums are added in mesh order on the first device
    (``parallel.mesh.mesh_sum``). On a CPU mesh each shard runs the plain
    version."""
    from ..parallel.mesh import mesh_sum

    params, static = _entry_config(n_paths, n_steps, S0s, weights, K, T, r,
                                   qs, sigmas, chol, is_call, payoff,
                                   barrier, barrier_type, rebate)
    reps, per, shards = _shard_plan(mesh, n_paths, TILE)
    inputs = [(_seed_pair(seed, dev, off), params.to(dev))
              for dev, off in shards]
    return mesh_sum([basket_mc(sd, prm, n_programs=per, reps=reps,
                               antithetic=bool(antithetic),
                               host_params=params, **static)
                     for sd, prm in inputs])
