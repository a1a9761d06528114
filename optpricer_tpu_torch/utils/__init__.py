"""Utilities of the PyTorch port: JSON persistence of calibration artifacts
(``serialization``)."""
