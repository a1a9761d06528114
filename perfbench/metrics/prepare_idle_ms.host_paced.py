"""``prepare_idle_ms`` in the host-paced cells."""
from .prepare_idle_ms import read  # noqa: F401
