"""State checkpoint / resume: the counterpart of
``rocquantum_tpu/utils/checkpoint.py``, writing its on-disk format.

The reference had none (SURVEY §5: "Checkpoint/resume: none"); its only
primitive was full state readback (rocsvGetStateVectorFull,
hipStateVec.cpp:691). A checkpoint is one ``.npz`` file holding the
state's real and imaginary parts (``re``, ``im``, in the state's real
dtype) and ``meta``, a JSON object with the parts' ``shape`` and, for a
Circuit, its ``num_qubits`` and ``batch_size``. Either package resumes the
other's checkpoints: a batched float64 state is written as the JAX package
holds it, one flat pair with element k at index bits [n, ...), the batch
padded to a power of two with zero elements.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .. import config


def _path(path: str) -> str:
    if not path.endswith(".npz") and not os.path.exists(path):
        return path + ".npz"
    return path


def _parts(state):
    """(re, im) host arrays of a complex tensor or of a float pair whose
    ``im`` may be None (a real carry)."""
    if isinstance(state, tuple):
        re, im = state
        if im is None:
            im = torch.zeros_like(re)
    else:
        re, im = state.real, state.imag
    return re.detach().cpu().numpy(), im.detach().cpu().numpy()


def save_state(path: str, state, metadata: Optional[dict] = None):
    """Write a complex state tensor, or a float-pair state ``(re, im)``, to
    ``path`` (.npz). Both forms produce the same on-disk pair format."""
    re, im = _parts(state)
    meta = dict(metadata or {})
    meta["shape"] = list(re.shape)
    np.savez(path, re=re, im=im, meta=json.dumps(meta))


def _load_parts(path: str, device):
    data = np.load(_path(path), allow_pickle=False)
    rdt = config.real_dtype()
    return (torch.as_tensor(data["re"], dtype=rdt, device=device),
            torch.as_tensor(data["im"], dtype=rdt, device=device))


def load_state(path: str, device=None) -> torch.Tensor:
    """Load a state saved by :func:`save_state` as a tensor of the
    precision's complex dtype on ``device`` (default: the card)."""
    if device is None:
        from ..api import default_device
        device = default_device()
    re, im = _load_parts(path, device)
    return torch.complex(re, im)


def load_metadata(path: str) -> dict:
    data = np.load(_path(path), allow_pickle=False)
    return json.loads(str(data["meta"]))


def _padded_rows(b: int) -> int:
    return 1 << max(b - 1, 0).bit_length()


def save_circuit_checkpoint(path: str, circuit) -> None:
    """Checkpoint a Circuit's state (in logical qubit order) + qubit count
    and batch size."""
    circuit.flush()
    circuit._restore_identity_layout()
    state = circuit.state
    b = circuit.batch_size
    if b > 1 and isinstance(state, tuple):
        # the JAX package's flat batched pair: rows padded to a power of 2
        pad = _padded_rows(b) - b
        state = tuple(torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(-1)
                      for x in state)
    save_state(path, state, {"num_qubits": circuit.num_qubits,
                             "batch_size": b})


def restore_circuit_checkpoint(path: str, circuit) -> None:
    """Resume a Circuit from a checkpoint (qubit counts must match), on the
    circuit's device, in the form its batch and the precision in force
    select: a complex64 ``(b, 2^n)`` tensor for a single-precision batch,
    else the float pair ``(re, im)``."""
    meta = load_metadata(path)
    if meta["num_qubits"] != circuit.num_qubits:
        raise ValueError(
            f"checkpoint has {meta['num_qubits']} qubits, circuit has "
            f"{circuit.num_qubits}")
    b, n = circuit.batch_size, circuit.num_qubits
    shapes = [[1 << n]] if b == 1 else [[b, 1 << n], [_padded_rows(b) << n]]
    if list(meta["shape"]) not in shapes:
        raise ValueError(f"checkpoint holds a state of shape "
                         f"{meta['shape']}, the circuit {shapes[0]}")
    circuit._gate_queue.clear()
    circuit._is_dirty = False
    circuit._layout = list(range(n))
    re, im = _load_parts(path, circuit.device)
    if b > 1:
        re, im = (x.reshape(-1, 1 << n)[:b].contiguous() for x in (re, im))
    if b > 1 and config.get_precision() == "single":
        circuit._state = torch.complex(re, im)
    else:
        circuit._state = (re, im)
