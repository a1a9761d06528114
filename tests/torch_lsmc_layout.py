"""The LSMC date kernel's stopping-date layout (``ops/lsmc.py``,
``csrc/lsmc.cu``), for the card tests and ``chip_smoke.py``, which set or
read its state: for each tile of 32 strikes and each group of 16 paths,
the 32 strikes' 16-byte words side by side, the paths padded to whole
chunks of 128."""
import torch

from optpricer_tpu_torch.ops import lsmc


def _shape(B: int, n: int):
    return -(-B // lsmc.TILE), -(-n // lsmc.CHUNK) * lsmc.CHUNK


def pack_tau(tau: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, n) uint8 stopping dates → the kernel's flat layout, the slots
    past B or n set to ``pad``. The loop leaves n_steps in the slots past n
    (their spots are NaN, never exercised), and the last date's pass sums
    each slot's cashflow: a state handed to it needs ``pad`` = n_steps."""
    B, n = tau.shape
    tiles, n_pad = _shape(B, n)
    full = torch.full((tiles * lsmc.TILE, n_pad), pad, dtype=torch.uint8,
                      device=tau.device)
    full[:B, :n] = tau
    return full.view(tiles, lsmc.TILE, n_pad // lsmc.GROUP,
                     lsmc.GROUP).permute(0, 2, 1, 3).reshape(-1)


def unpack_tau(flat: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """The kernel's flat layout → (B, n) uint8 stopping dates."""
    tiles, n_pad = _shape(B, n)
    return flat.view(tiles, n_pad // lsmc.GROUP, lsmc.TILE,
                     lsmc.GROUP).permute(0, 2, 1, 3).reshape(
                         tiles * lsmc.TILE, n_pad)[:B, :n]
