"""``estimate_idle_ms`` in the host-paced cells."""
from .estimate_idle_ms import read  # noqa: F401
