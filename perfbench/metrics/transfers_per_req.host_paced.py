"""``transfers_per_req`` in the host-paced cells."""
from .transfers_per_req import read  # noqa: F401
