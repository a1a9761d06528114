"""The interpreted TPU path kernel's Dupire statistics, computed without FMA.

Run as a script in a process of its own, with ``XLA_FLAGS`` holding
``--xla_cpu_max_isa=AVX`` (``tests/test_torch_path_mc.py`` starts it so):
XLA:CPU then emits no fused multiply-adds. By default it contracts
``a * b + c`` into one FMA wherever the ISA has one, which the IEEE kernel
(built with ``-fmad=false``) and its plain version never do, and the f32
difference quotient ∂w/∂T of σ_loc turns each such rounding into ~2e-4 of
σ. Writes an ``.npz`` with, for each case ``"<variant>|<scheme>"``:

* ``ref|<case>``: ``path_mc_sumstats_pallas(..., interpret=True,
  sw_prng=True)``, the reference's 21 statistics;
* ``same_normals|<case>``: the port's plain version on the same call, with
  the Box-Muller ``cos``/``sin`` taken from XLA:CPU as the interpreted
  kernel takes them (torch's differ by an ulp here and there), so that
  the rest of the path arithmetic is held alone.

Usage: ``python tests/torch_lv_reference.py OUT.npz``.
"""
import os
import sys
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(out_path: str):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from optpricer_tpu.ops import pallas_path_mc as jpm
    from optpricer_tpu_torch.ops import path_mc as tpm
    from tests.test_torch_path_mc import (LV_CASES, LV_MARKET, SVI,
                                          VARIANTS)

    torch.set_num_threads(1)

    def xla(fn):
        return lambda x: torch.from_numpy(np.asarray(fn(jnp.asarray(
            x.numpy()))))

    out = {}
    for variant, scheme in LV_CASES:
        kw, is_call = VARIANTS[variant]
        call = dict(antithetic=True, svi_slices=SVI, scheme=scheme, **kw)
        case = f"{variant}|{scheme}"
        out[f"ref|{case}"] = np.asarray(jpm.path_mc_sumstats_pallas(
            7, 4096, 8, *LV_MARKET, is_call, interpret=True, sw_prng=True,
            **call))
        with mock.patch.object(torch, "cos", xla(jnp.cos)), \
                mock.patch.object(torch, "sin", xla(jnp.sin)):
            out[f"same_normals|{case}"] = tpm.path_mc_sumstats_kernel(
                7, 4096, 8, *LV_MARKET, is_call, device="cpu",
                **call).numpy()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
