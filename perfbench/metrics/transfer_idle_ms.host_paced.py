"""``transfer_idle_ms`` in the host-paced cells."""
from .transfer_idle_ms import read  # noqa: F401
