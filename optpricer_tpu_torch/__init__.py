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
from .models.mc_fused import (exotic_greeks_mc, exotic_price_mc,
                              exotic_price_mc_dupire)
from .models.analytic import geometric_asian_price

# Exotic payoffs on a path matrix
from .models.exotics import (barrier_price, asian_price, digital_price,
                             lookback_price, double_barrier_price)

# Calibration & Dupire
from .models.calibration import (SVIParams, VolSurface, fit_svi,
                                 fit_svi_surface, dupire_local_vol,
                                 dupire_local_vol_func, fit_essvi,
                                 svi_butterfly_g, svi_density,
                                 check_butterfly, check_calendar,
                                 arbitrage_report)

# Stochastic processes
from .models.processes import (gbm_paths, merton_jump_paths, heston_paths,
                               bates_paths, sabr_paths, local_vol_paths,
                               gbm_milstein_paths, milstein_local_vol_paths)

# Risk engine
from .risk import (numerical_greeks, scenario_grid, portfolio_risk,
                   var_historical, cvar_historical)
from .risk import ad_greeks, exposure_profile, portfolio_risk_fast

# PDE (finite difference, finite element)
from .models.pde import (fd_price, fd_price_barrier,
                         fd_price_double_barrier, fd_greeks,
                         fd_price_local_vol)
from .models.fem import fem_price

# Production data model
from .core import Instrument, MarketData, to_instrument_market

# Vectorised pricers
from .ops.black_scholes import (bs_price_vec, bs_greeks_vec,
                                bs_implied_vol_vec, bs_higher_greeks_vec)
from .models.binomial import crr_vec
from .models.pde import fd_price_batch, fd_price_local_vol_batch

# Model validation
from .validation import (cross_validate, convergence_analysis, stress_test,
                         backtest_delta_hedge)

# Closed forms, COS transforms, analytic Americans and Lévy models
from .models.analytic import (merton_price, heston_price_cos,
                              bates_price_cos, quanto_price,
                              quanto_adjusted_carry,
                              sabr_implied_vol, sabr_price_hagan,
                              fit_heston, heston_greeks_cos, cev_price,
                              barrier_price_bs, chooser_price,
                              compound_price, lookback_price_bs,
                              double_barrier_price_bs)
from .models.levy import (vg_price_cos, nig_price_cos, cgmy_price_cos,
                          vg_paths, nig_paths, fit_vg)
from .models.binomial import american_implied_vol
from .models.american_analytic import (bjerksund_stensland_price,
                                       baw_price, rgw_price)

# Multi-asset and LSV
from .models.basket import (basket_price_mc, basket_greeks_mc,
                            basket_exotic_mc, geometric_basket_price,
                            margrabe_price, rainbow_price_stulz)
from .ops.bvn import bvn_cdf
from .models.lsv import (LSVModel, lsv_calibrate, lsv_greeks_mc,
                         lsv_path_matrix, lsv_price_mc)

# American and multilevel Monte Carlo
from .models.mlmc import mlmc_price
from .models.american_mc import (lsmc_price, lsmc_price_basket,
                                 lsmc_price_batch, lsmc_price_sharded)

__all__ = [
    # Legacy
    "OptionSpec", "CALL", "PUT",
    "bs_price", "bs_greeks", "implied_vol",
    "euro_price_mc", "euro_greeks_mc", "crr",
    "exotic_price_mc", "exotic_price_mc_dupire", "exotic_greeks_mc",
    "geometric_asian_price",
    "barrier_price", "asian_price", "digital_price", "lookback_price",
    "double_barrier_price",
    "SVIParams", "VolSurface", "fit_svi", "fit_svi_surface",
    "dupire_local_vol", "dupire_local_vol_func", "fit_essvi",
    "svi_butterfly_g", "svi_density", "check_butterfly", "check_calendar",
    "arbitrage_report",
    "gbm_paths", "merton_jump_paths", "heston_paths", "bates_paths",
    "sabr_paths", "local_vol_paths", "gbm_milstein_paths",
    "milstein_local_vol_paths",
    "numerical_greeks", "scenario_grid", "portfolio_risk", "var_historical",
    "cvar_historical", "ad_greeks", "portfolio_risk_fast", "exposure_profile",
    "fd_price", "fd_price_barrier", "fd_price_double_barrier", "fd_greeks",
    "fd_price_local_vol", "fem_price",
    # Production data model
    "Instrument", "MarketData", "to_instrument_market",
    # Vectorised
    "bs_price_vec", "bs_greeks_vec", "bs_implied_vol_vec", "crr_vec",
    "bs_higher_greeks_vec", "fd_price_batch", "fd_price_local_vol_batch",
    # Validation
    "cross_validate", "convergence_analysis", "stress_test",
    "backtest_delta_hedge",
    # Closed forms, COS, analytic Americans, Lévy
    "merton_price", "heston_price_cos", "bates_price_cos", "cev_price",
    "barrier_price_bs", "lookback_price_bs", "double_barrier_price_bs",
    "quanto_price", "quanto_adjusted_carry", "sabr_implied_vol",
    "sabr_price_hagan", "fit_heston", "heston_greeks_cos",
    "chooser_price", "compound_price",
    "american_implied_vol",
    "vg_price_cos", "nig_price_cos", "cgmy_price_cos",
    "vg_paths", "nig_paths", "fit_vg",
    "bjerksund_stensland_price", "baw_price", "rgw_price",
    # Multi-asset and LSV
    "basket_price_mc", "basket_greeks_mc", "basket_exotic_mc",
    "geometric_basket_price", "margrabe_price", "rainbow_price_stulz",
    "bvn_cdf",
    "LSVModel", "lsv_calibrate", "lsv_greeks_mc", "lsv_path_matrix",
    "lsv_price_mc",
    # American and multilevel Monte Carlo
    "mlmc_price", "lsmc_price", "lsmc_price_batch", "lsmc_price_sharded",
    "lsmc_price_basket",
]

__version__ = "0.1.0"
