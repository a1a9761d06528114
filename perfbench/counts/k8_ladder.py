"""Least work of the fused local-vol θ-scheme ladder. A frozen copy of
``chip_smoke.py``'s ``ops_k8_ladder`` and of the bytes it is bounded
with."""


def ops_k8_ladder(n_strikes: int, m: int, n_t: int,
                  american: bool = False) -> float:
    """Per strike, row and step the rhs (three products of the layer with
    the row's coefficients and two adds, 5), the forward elimination
    (d' = (d − a·d'_prev)·rcp, 3), the back substitution (2) and, American,
    the projection against the intrinsic value (1); per row and step,
    shared by every strike, σ's operator coefficients, the pivot c' and its
    reciprocal (~25)."""
    return ((10 + american) * n_strikes + 25) * m * n_t


def least_work(config: dict, traffic: dict, request: dict):
    """(operations, bytes) of one ladder: the march of every strike; the
    σ table (N_t x (m + 1) f32), the (m + 1, B) layer written, the strikes
    and signs and six parameters."""
    s = traffic["sizes"]
    B = len(request["K"])
    m, n_t = s["N_S"] - 1, s["N_t"]
    return (ops_k8_ladder(B, m, n_t),
            4 * (n_t * (m + 1) + (m + 1) * B + 2 * B + 6))
