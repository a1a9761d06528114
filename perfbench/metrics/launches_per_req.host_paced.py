"""``launches_per_req`` in the host-paced cells."""
from .launches_per_req import read  # noqa: F401
