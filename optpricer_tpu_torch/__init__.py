# optpricer_tpu_torch — the options pricing engine on PyTorch + CUDA (H100).
#
# A port of optpricer_tpu (JAX / Pallas), which stays beside it as the
# reference. Plain tensor code is PyTorch; every kernel on the ported path
# is CUDA C++ for sm_90a in csrc/, built with nvcc at first use. The public
# names and signatures follow optpricer_tpu; every engine takes device=
# (default "cuda"). This package never imports jax.

# Legacy scalar interface
from .core import OptionSpec, CALL, PUT
from .ops.black_scholes import (
    price as bs_price,
    greeks as bs_greeks,
    implied_vol,
)
from .models.monte_carlo import euro_greeks_mc, euro_price_mc
from .models.binomial import crr

# Production data model
from .core import Instrument, MarketData, to_instrument_market

# Vectorised pricers
from .ops.black_scholes import (bs_price_vec, bs_greeks_vec,
                                bs_implied_vol_vec, bs_higher_greeks_vec)
from .models.binomial import crr_vec

__all__ = [
    # Legacy
    "OptionSpec", "CALL", "PUT",
    "bs_price", "bs_greeks", "implied_vol",
    "euro_price_mc", "euro_greeks_mc", "crr",
    # Production data model
    "Instrument", "MarketData", "to_instrument_market",
    # Vectorised
    "bs_price_vec", "bs_greeks_vec", "bs_implied_vol_vec", "crr_vec",
    "bs_higher_greeks_vec",
]

__version__ = "0.1.0"
