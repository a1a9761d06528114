"""The 95th percentile of every request's host-clock latency in the traced
run of a host-paced cell, where the host's pace, not the device's, sets
the tail."""
from .latency_p95_ms import read  # noqa: F401
