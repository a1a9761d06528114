"""Least work of the American ladder by Longstaff-Schwartz: B strikes on
one matrix of n paths and n_steps steps, the basis the k powers of
S/S0 − 1, regressions at the n_steps − 1 dates between t = 0 and
maturity. An FMA counts two operations, every other operation one, at
float32, whatever kernels implement the work.

Per strike, path and regression date (``OPS_STRIKE_DATE``, k = 4: 42):

* 2: the intrinsic value, K − S and its max with 0;
* 1: the in-the-money mask;
* 1: the discount of the carried cashflow;
* 1: the weighted cashflow, the mask's select of it;
* 2·(k(k+1)/2 + k): the normal equations' sums of products, XᵀWX's
  k(k+1)/2 distinct entries and XᵀWy's k, an FMA each;
* 2·(k − 1): the k-term fit β·X, β₀ plus k − 1 FMAs;
* 3: the exercise select, intrinsic against the fit, and with the mask,
  then the select.

Per path and date, shared by the strikes (``OPS_PATH_DATE``): x = S/S0 − 1
(an FMA) and its powers to x^{2(k−1)} that XᵀWX needs (2k − 3 products).
Per path and step (``OPS_PATH_STEP``): the exponent's FMA, an exp32 (22)
and the product with the spot; per base draw and step a standard normal
(65, as the path counts take it). Per strike and path, once: the terminal
payoff (2) and the moments of the discounted cashflow (the discount, a
sum and an FMA for the sum of squares: 4). The batched k × k solves and
the floor at t = 0 are below a part in 10⁵ of the rest and are left out.

Bytes: a state per strike and path has to survive from one date to the
next, since each date's regression is a reduction over every path before
any path's exercise at that date is known, and B·n of it does not fit in
the card's 50 MB L2 (1.0 GB at the cell's size in one byte each). The
least such state is the path's stopping date, one byte (the cashflow is
the payoff at that date, read from the path matrix that the strikes
share), read and written once a date. The path matrix is written once and
read once (float32), the strikes read and the prices and standard errors
written. Recomputing the cashflow from the policy in place of the state
costs more operations than the two bytes: 9 a later date, against the
card's 20 operations a byte.
"""

OPS_NORMAL = 65
OPS_PATH_STEP = 2 + 22 + 1
OPS_STRIKE_PATH = 2 + 4


def ops_strike_date(k: int) -> int:
    return 2 + 1 + 1 + 1 + 2 * (k * (k + 1) // 2 + k) + 2 * (k - 1) + 3


def ops_path_date(k: int) -> int:
    return 2 + (2 * k - 3)


def least_work(config: dict, traffic: dict, request: dict):
    """(operations, bytes) of one ladder request."""
    s = traffic["sizes"]
    B = len(request["K"])
    base, n_steps, k = int(s["n_paths"]), int(s["n_steps"]), int(
        s["basis_dim"])
    n = base * (2 if s["antithetic"] else 1)
    dates = n_steps - 1
    ops = (base * n_steps * OPS_NORMAL + n * n_steps * OPS_PATH_STEP
           + n * dates * ops_path_date(k)
           + B * n * (dates * ops_strike_date(k) + OPS_STRIKE_PATH))
    n_bytes = (2 * B * n * dates + 2 * 4 * n * (n_steps + 1)
               + 4 * B + 2 * 4 * B)
    return ops, n_bytes
