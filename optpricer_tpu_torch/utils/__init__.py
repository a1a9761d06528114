"""Utilities of the PyTorch port: timing and profiling (``timing``,
``profiling``) and JSON persistence of calibration artifacts
(``serialization``)."""
from .timing import Timer, benchmark  # noqa: F401
