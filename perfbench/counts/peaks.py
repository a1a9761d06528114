"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
700 W) and the roofline bound. A frozen copy of ``chip_smoke.py``'s
``PEAK_OPS``, ``PEAK_BYTES`` and ``bound``: integer operations are counted
at the float32 rate."""

PEAK_OPS = 67e12        # float32 outside the tensor cores, operations/s
PEAK_BYTES = 3.35e12    # HBM3, bytes/s


def bound(ops: float, n_bytes: float):
    """(bound_ms, bound_by): the larger of ops/peak and bytes/rate."""
    t_ops, t_bytes = ops / PEAK_OPS, n_bytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"
