"""``device_idle_pct`` in the host-paced cells."""
from .device_idle_pct import read  # noqa: F401
