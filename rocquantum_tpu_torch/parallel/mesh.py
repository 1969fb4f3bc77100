"""Device-mesh construction.

Counterpart of ``rocquantum_tpu/parallel/mesh.py``. A :class:`Mesh` is a
numpy object array of ``torch.device`` s with one name per axis, read as
JAX's mesh is read (``mesh.shape[name]``, ``mesh.axis_names``,
``mesh.devices``). A device may repeat: ``devices=[torch.device("cuda:0")]
* 8`` asks for eight virtual shards on one card (the CPU tests pass
``[torch.device("cpu")] * 8``). Without ``devices`` a mesh takes the CUDA
devices and, where there is none, raises: it never falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

SV_AXIS = "sv"      # amplitude (state-vector) sharding axis
BATCH_AXIS = "dp"   # batched-simulation axis
DCN_AXIS = "dcn"    # cross-slice axis: amplitude sharding spans (dcn, sv)


class Mesh:
    """Devices on named axes: ``devices`` is an object array whose shape
    gives each axis its size, in ``axis_names`` order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        flat = np.empty(devs.size, dtype=object)
        flat[:] = [torch.device(d) for d in devs.ravel()]
        self.devices = flat.reshape(devs.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.ravel()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        devices = sorted(set(map(str, self.devices.ravel())))
        return f"Mesh({self.shape}, devices={devices})"


def _devices(devices: Optional[Sequence]):
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices= (for "
                           "example [torch.device('cpu')] * 8) to build a "
                           "mesh elsewhere")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _check_power_of_two(size: int, name: str):
    if size < 1 or size & (size - 1):
        raise ValueError(f"{name} size must be a power of two: {size}")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SV_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all of ``devices``, which
    default to every CUDA device)."""
    devices = _devices(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} exist")
        devices = devices[:n_devices]
    n = len(devices)
    if n & (n - 1) or n == 0:
        raise ValueError(f"number of devices must be a power of two, got {n} "
                         "(reference constraint: bit-sliced state, "
                         "MULTI_GPU_GUIDE.md:19)")
    return Mesh(devices, (axis_name,))


def make_mesh_2d(dp: int, sv: int, devices: Optional[Sequence] = None) -> Mesh:
    """(batch, amplitude) mesh for batched sharded simulation."""
    devices = _devices(devices)
    if dp * sv > len(devices):
        raise ValueError(f"mesh {dp}x{sv} needs {dp*sv} devices, "
                         f"have {len(devices)}")
    arr = np.empty(dp * sv, dtype=object)
    arr[:] = devices[:dp * sv]
    return Mesh(arr.reshape(dp, sv), (BATCH_AXIS, SV_AXIS))


def make_mesh_multislice(dcn: int, sv: int,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(slice, amplitude) mesh: the amplitude axis spans both axes, the top
    log2(dcn) index bits selecting the slice."""
    devices = _devices(devices)
    if dcn * sv > len(devices):
        raise ValueError(f"mesh {dcn}x{sv} needs {dcn*sv} devices, "
                         f"have {len(devices)}")
    for size, name in ((dcn, "dcn"), (sv, "sv")):
        _check_power_of_two(size, name)
    arr = np.empty(dcn * sv, dtype=object)
    arr[:] = devices[:dcn * sv]
    return Mesh(arr.reshape(dcn, sv), (DCN_AXIS, SV_AXIS))


def default_mesh() -> Mesh:
    """A 1-D mesh over every CUDA device (raises without one)."""
    return make_mesh()
