"""Device-mesh data parallelism, single-controller.

Counterpart of ``optpricer_tpu/parallel/mesh.py``. The JAX package's mesh
is a ``jax.sharding.Mesh``: one Python process drives every device, each
runs its shard of a ``shard_map`` and the sufficient statistics ride one
``psum``. The port keeps that shape of call: a :class:`Mesh` is an array of
``torch.device`` with axis names, a sharded call launches every shard on
its own device before it waits for any of them, and the per-shard
statistics are then summed in mesh order on the mesh's first device, in
their dtype, with no atomics (:func:`mesh_sum`, the ``psum``). So a run
repeats bit for bit, and ``mesh=`` stays an argument of an ordinary call
(no process group, no launcher).

A mesh may repeat a device — ``get_mesh(devices=["cpu"] * 8)`` is the
port's counterpart of the test suite's 8-device virtual CPU mesh, and
``["cuda:0"] * 4`` runs a 4-way mesh on one card, whose shards then run
one after another — which JAX's ``Mesh`` refuses. A mesh holds one device
type: a CPU and a CUDA ``torch.Generator`` give different streams.

Every mesh-taking entry point shards over all of a mesh's axes jointly,
in row-major device order, so a 2-D ``(slice, chip)`` mesh from
:func:`get_mesh_multislice` is sharded as its flattened device list.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..dtypes import resolve_device

__all__ = ["get_mesh", "get_mesh_multislice", "mesh_axes",
           "mc_sumstats_sharded"]


class Mesh:
    """An n-D array of ``torch.device`` with one name per axis.

    ``devices`` is a numpy object array (``mesh.devices.size`` counts the
    shards, as for a JAX mesh); ``device_list`` is its row-major list.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [resolve_device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in flat}) != 1:
            raise ValueError(
                "a mesh holds one device type (a CPU and a CUDA generator "
                f"give different streams), got {sorted(map(str, flat))}")
        shape = np.shape(np.asarray(devices, dtype=object))
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")

    @property
    def device_list(self) -> list:
        return list(self.devices.reshape(-1))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


def mesh_axes(mesh: Mesh) -> tuple:
    """All axis names of ``mesh``: every sharded call splits its work over
    all of them jointly, in row-major device order, and sums over all."""
    return tuple(mesh.axis_names)


def _local_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "get_mesh() takes the CUDA devices and torch.cuda.is_available() "
            "is false; pass devices=['cpu'] * n for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_mesh(n_devices: Optional[int] = None, axis: str = "paths",
             devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices: by default the
    CUDA devices, else ``devices`` (names or ``torch.device``, repeats
    allowed, one device type)."""
    devices = _local_devices() if devices is None else list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def get_mesh_multislice(n_slices: int, chips_per_slice: Optional[int] = None,
                        axes: Sequence[str] = ("slice", "chip"),
                        devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``(slice, chip)`` mesh: the trailing axis within a slice, the
    leading one across slices, laid out row-major from ``devices`` (by
    default the CUDA devices)."""
    devices = _local_devices() if devices is None else list(devices)
    if chips_per_slice is None:
        chips_per_slice = len(devices) // n_slices
    if n_slices < 1 or chips_per_slice < 1:
        raise ValueError(f"cannot lay out {n_slices} slice(s) × "
                         f"{chips_per_slice} chip(s) over "
                         f"{len(devices)} devices")
    n = n_slices * chips_per_slice
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_slices, chips_per_slice), tuple(axes))


def mesh_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ``psum``: the shards' stats summed in mesh order on the first
    shard's device, in their dtype."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part.to(acc.device)
    return acc


def shard_ranges(n: int, n_dev: int) -> list:
    """Contiguous (start, stop) of each of ``n_dev`` shards of ``n`` items
    (``n`` a multiple of ``n_dev``)."""
    per = n // n_dev
    return [(d * per, (d + 1) * per) for d in range(n_dev)]


def mc_sumstats_sharded(
    mesh: Mesh, key, n_chunks: int, n_paths, S0, K, T, r, q, sigma, is_call,
    *, chunk_size: int, antithetic: bool, dtype,
):
    """Mesh-parallel chunk scan: shard the chunk ids, sum the stats.

    ``key`` is the run's integer seed (the port's counterpart of the JAX
    key). The chunk grid is padded to a multiple of the mesh size; padded
    ids fall beyond ``n_paths`` and weigh 0, and a chunk's draws depend on
    (seed, chunk id) alone, so the result equals the one-device scan over
    ``range(n_chunks)`` up to the order of the sum. Returns the (13,)
    stats on the mesh's first device.
    """
    from ..models.monte_carlo import mc_sumstats

    devices = mesh.device_list
    n_dev = len(devices)
    padded = -(-int(n_chunks) // n_dev) * n_dev
    # the scan enqueues its work with no host sync: every shard is
    # launched before any is waited for
    parts = [mc_sumstats(key, range(lo, hi), n_paths, S0, K, T, r, q, sigma,
                         is_call, chunk_size=chunk_size,
                         antithetic=antithetic, dtype=dtype, device=dev)
             for dev, (lo, hi) in zip(devices, shard_ranges(padded, n_dev))]
    return mesh_sum(parts)
