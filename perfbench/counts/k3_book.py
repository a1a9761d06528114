"""Least work of the European book priced by terminal Monte Carlo with
antithetic pairs and the dual control variate.

This count replaces ``chip_smoke.py``'s ``OPS_K3_DRAW = 150``, which
counted its source's work, Kahan steps included. Here every term is what
the function needs, whatever implements it, per base draw of a contract:

* 65: one standard normal: half a Threefry-2x32-20 block (40) and half a
  Box-Muller pair (25), as the path counts take them;
* 58: two states (z and −z), each the exponent's FMA (2), an exp32 (22),
  the product with S0 (1), S_T − K times the sign (2), the payoff's max
  (1) and the in-the-money indicator (1);
* 6: the pair averages of the payoff, S_T and the indicator, the discount
  folded into the halving (an add and a multiply each);
* 15: the moments of the dual-CV estimator with no compensation: three
  sums (1 each) and six sums of products (an FMA each); the count of draws
  is known and costs nothing.
"""

OPS_BOOK_DRAW = 65 + 58 + 6 + 15     # = 144


def least_work(config: dict, traffic: dict, request: dict):
    """(operations, bytes) of one book: every contract's base draws; the
    seed and parameters, eight f32 rows a contract in and ten sums out."""
    B = len(request["K"])
    n = traffic["sizes"]["n_paths"]
    return B * n * OPS_BOOK_DRAW, 8 + 4 * 8 * B + 4 * 10 * B
