"""One Qiskit job: the cell's circuit built as a ``QuantumCircuit``
(``ry``/``cx`` and the other named gates, ``unitary`` for an ``SU4`` with
its matrix from ``reference.dense.matrix`` of the request's draw), a
measurement of every qubit into its classical bit, then
``RocQuantumProvider().get_backend("rocq_simulator").run(qc,
shots=traffic["shots"])`` on a backend made once per process on the
program's device, answered by ``result.get_counts()``. The kind owns its
request: on the program it goes through the port's Qiskit plugin; on a
control, the reference in the control's dtype is sampled by
``statevector.sample``. It imports ``qiskit`` where it is installed, else
the repository's API stand-ins (``tests/_stubs``).

Compared, over the checked requests' draws (the counts expanded) and the
float64 reference's p(x) = |psi_ref(x)|^2:

- ``xeb_dev`` and ``dup_z`` as ``requests/shots.py`` defines them;
- ``state_err``: the last request's state, read through the plugin's
  public ``get_statevector()`` (the control's own), against the reference
  slice by slice by ``harness._state_error``: max |psi - psi_ref| /
  max |psi_ref|.

Counts that do not add up to the shots, or name an outcome out of range,
read inf.
"""

import os
import sys

import numpy as np
import torch

from portbench import workload
from portbench.reference import dense
from portbench.reference import statevector as ref

NUMBERS = ("xeb_dev", "dup_z", "state_err")

_BACKENDS = {}  # device -> the plugin's backend, made once per process
_HELD = {}  # "state": a control's last reference state


def _qiskit():
    """``qiskit``, or the stand-ins in the program's checkout
    (``tests/_stubs`` beside the ``rocquantum_tpu_torch`` package)."""
    try:
        import qiskit
    except ImportError:
        import rocquantum_tpu_torch
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            rocquantum_tpu_torch.__file__)))
        sys.path.append(os.path.join(root, "tests", "_stubs"))
        import qiskit
    return qiskit


def backend(device):
    """The port's Qiskit backend on ``device``, made at first use."""
    key = str(device)
    if key not in _BACKENDS:
        _qiskit()
        from rocquantum_tpu_torch.integrations.qiskit_provider import \
            RocQuantumProvider
        _BACKENDS[key] = RocQuantumProvider(device=device).get_backend(
            "rocq_simulator")
    return _BACKENDS[key]


def circuit(cell, theta):
    """The cell's gates and a measurement of every qubit as a
    ``QuantumCircuit``."""
    qc = _qiskit().QuantumCircuit(cell.n, cell.n)
    for name, qubits, param in cell.gates:
        if name == "SU4":
            qc.unitary(dense.matrix(theta[param]), list(qubits))
            continue
        angle = () if param is None else (float(theta[param]),)
        getattr(qc, name.lower())(*angle, *qubits)
    qc.measure(list(range(cell.n)), list(range(cell.n)))
    return qc


def counts_of(draws, n):
    """Qiskit's counts of int draws: bit strings, qubit 0 rightmost."""
    values, counts = np.unique(np.asarray(draws, np.int64),
                               return_counts=True)
    return {format(int(v), f"0{n}b"): int(c) for v, c in zip(values, counts)}


def draws_of(counts, n):
    """The draws of a counts dict, as int64 (order lost), or None when a
    key is no n-bit string."""
    keys = list(counts)
    if any(len(k) != n or set(k) - {"0", "1"} for k in keys):
        return None
    values = np.array([int(k, 2) for k in keys], np.int64)
    return np.repeat(values, [int(counts[k]) for k in keys])


def request(system, theta, cell, traffic):
    from portbench import harness
    shots = traffic["shots"]
    if isinstance(system, harness.Control):
        state = dense.simulate(cell.n, cell.gates, theta, system.dtype,
                               system.devices.list)
        _HELD["state"] = state
        return counts_of(ref.sample(state, shots, system.gen), cell.n)
    qc = circuit(cell, theta)
    result = backend(system.sim.device).run(qc, shots=shots)
    return result.get_counts()


def _held_planes(devices):
    """``read(start, size) -> (re, im)`` of the last request's state:
    the control's reference, or the plugin's ``get_statevector()``; None
    where no request ran a circuit there."""
    if "state" in _HELD:
        state = _HELD["state"]
        return lambda start, size: ref.planes(state, start, size)
    if str(devices[0]) not in _BACKENDS:
        return None
    try:
        vec = _BACKENDS[str(devices[0])].get_statevector()
    except RuntimeError:
        return None

    def read(start, size):
        part = vec[start:start + size]
        return (torch.from_numpy(np.ascontiguousarray(part.real)),
                torch.from_numpy(np.ascontiguousarray(part.imag)))
    return read


def compare(cell, traffic, checked, dtype, devices):
    """``checked`` yields ``(answer, theta)`` one request at a time, the
    last request last. The held state is compared by the harness's own
    ``_state_error``."""
    from portbench import harness
    shots_kind = workload.load_module("requests", "shots")
    inf = {k: float("inf") for k in NUMBERS}
    xeb_num, draws, dup_z, state = 0.0, 0, [], None
    for answer, theta in checked:
        del state
        shots = draws_of(answer, cell.n) if isinstance(answer, dict) \
            else None
        if shots is None or shots.size != traffic["shots"]:
            return inf
        state = dense.simulate(cell.n, cell.gates, theta, dtype, devices)
        q2, q3 = ref.power_sum(state, 2), ref.power_sum(state, 3)
        xeb_num += float(ref.probabilities_at(state, shots).sum()) / q2
        draws += shots.size
        dup_z.append(shots_kind.duplicate_z(shots, q2, q3))
    if not draws:
        return inf
    read = _held_planes(devices)
    err = np.inf if read is None else harness._state_error(
        cell.n, state, None, lambda _handle, s, k: read(s, k))
    _HELD.clear()
    return {"xeb_dev": abs(xeb_num / draws - 1), "dup_z": max(dup_z),
            "state_err": err}
