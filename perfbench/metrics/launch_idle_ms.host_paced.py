"""``launch_idle_ms`` in the host-paced cells."""
from .launch_idle_ms import read  # noqa: F401
