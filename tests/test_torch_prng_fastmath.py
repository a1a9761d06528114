"""Port vs reference: the in-kernel generator and fast math.

The CUDA kernels inline device forms of these functions; their plain torch
forms (``optpricer_tpu_torch/ops/swprng.py``, ``ops/fastmath.py``) are what
the CPU path runs, and they are held here against the JAX package's own
functions on the same numpy-made inputs.

Tolerances: Threefry and the bit reversal are integer code and must agree
bit for bit. ``exp32`` and ``log32`` are held to 1 ulp (0 measured over the
ranges below); ``norminv32`` to 4 ulps (3 measured over the whole 24-bit
uniform grid): XLA:CPU contracts some of its Horner multiply-adds into
FMAs, torch's CPU kernels round each operation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import fastmath as jfm
from optpricer_tpu.ops import swprng as jsw
from optpricer_tpu.ops.pallas_mc import _bitrev32 as j_bitrev32
from optpricer_tpu_torch.ops import fastmath as tfm
from optpricer_tpu_torch.ops import swprng as tsw
from tests.torch_threads import torch_one_thread  # noqa: F401


def _max_ulp(a: np.ndarray, b: np.ndarray) -> int:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def _u32_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def test_threefry_bit_exact():
    rng = np.random.default_rng(0)
    n = 100_000
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    ctrs = rng.integers(0, 2**32, size=(2, n), dtype=np.uint32)
    ref_fn = jax.jit(jsw.threefry2x32)
    # one key pair per counter pair, then one scalar key (as in the kernels)
    for k0, k1 in ((keys[0], keys[1]), (int(keys[0, 0]), int(keys[1, 0]))):
        ref0, ref1 = ref_fn(jnp.asarray(k0, jnp.uint32),
                            jnp.asarray(k1, jnp.uint32),
                            jnp.asarray(ctrs[0]), jnp.asarray(ctrs[1]))
        key0 = _u32_tensor(k0) if isinstance(k0, np.ndarray) else k0
        key1 = _u32_tensor(k1) if isinstance(k1, np.ndarray) else k1
        got0, got1 = tsw.threefry2x32(key0, key1, _u32_tensor(ctrs[0]),
                                      _u32_tensor(ctrs[1]))
        np.testing.assert_array_equal(got0.numpy(), np.asarray(ref0))
        np.testing.assert_array_equal(got1.numpy(), np.asarray(ref1))


def test_threefry_known_answer():
    # Random123 known-answer vector: threefry2x32-20, key=0, ctr=0
    x0, x1 = tsw.threefry2x32(0, 0, 0, 0)
    assert int(x0) == 0x6B200159 and int(x1) == 0x99BA4EFE


def test_bitrev32_exact():
    v = np.random.default_rng(1).integers(0, 2**32, size=100_000,
                                          dtype=np.uint32)
    ref = np.asarray(j_bitrev32(jnp.asarray(v)))
    np.testing.assert_array_equal(tfm.bitrev32(_u32_tensor(v)).numpy(), ref)


@pytest.mark.parametrize("lo,hi", [(-85.0, 85.0), (-5.0, 5.0)])
def test_exp32_within_one_ulp(lo, hi):
    x = np.random.default_rng(2).uniform(lo, hi, 400_000).astype(np.float32)
    ref = np.asarray(jfm.exp32(jnp.asarray(x)))
    got = tfm.exp32(torch.from_numpy(x)).numpy()
    assert _max_ulp(got, ref) <= 1


def test_log32_within_one_ulp():
    rng = np.random.default_rng(3)
    # positive normals across the exponent range, plus the 24-bit grid
    u = np.concatenate([
        np.exp(rng.uniform(-85.0, 85.0, 200_000)),
        (np.arange(1, 2**20) + 0.5) / 2**20,
    ]).astype(np.float32)
    ref = np.asarray(jfm.log32(jnp.asarray(u)))
    got = tfm.log32(torch.from_numpy(u)).numpy()
    assert _max_ulp(got, ref) <= 1


def test_norminv32_within_four_ulps_on_uniform_grid():
    # every 5th bin midpoint of the kernels' 24-bit uniform grid, (0, 1)
    # end to end (3 ulps measured on the whole grid)
    u = ((np.arange(0, 2**24, 5) + 0.5) * 2.0**-24).astype(np.float32)
    ref = np.asarray(jfm.norminv32(jnp.asarray(u)))
    got = tfm.norminv32(torch.from_numpy(u)).numpy()
    assert _max_ulp(got, ref) <= 4
