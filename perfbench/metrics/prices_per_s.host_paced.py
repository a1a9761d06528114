"""``prices_per_s`` in the host-paced cells."""
from .prices_per_s import read  # noqa: F401
