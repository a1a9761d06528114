"""``host_ms_per_req`` in the host-paced cells."""
from .host_ms_per_req import read  # noqa: F401
