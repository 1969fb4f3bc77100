"""The port's Qiskit, Cirq and PennyLane plugins
(``rocquantum_tpu_torch/integrations/``, ``device="cpu"``) against the JAX
package's on the same circuits at n = 2-6.

Where qiskit, cirq or pennylane are not installed, ``tests/conftest.py``
puts the in-repo API stubs (``tests/_stubs``) on the path, and both
packages' plugins subclass the same stub base classes. Compared:
statevectors within 1e-5 of max|amp|, analytic probabilities and
marginals within 1e-6, the counts' keys and formatting, Cirq's bit order
and PennyLane's shapes and wire order. The six cases of
``tests/test_integrations.py`` run again on the port; draws repeat under
one seed, and each plugin raises without CUDA unless the CPU is asked.
"""

import numpy as np
import pytest
import torch

import cirq
import pennylane as qml
from qiskit import QuantumCircuit

from rocquantum_tpu.integrations import cirq_simulator as jax_cirq
from rocquantum_tpu.integrations import pennylane_device as jax_pl
from rocquantum_tpu.integrations import qiskit_provider as jax_qiskit
from rocquantum_tpu_torch.integrations import cirq_simulator as port_cirq
from rocquantum_tpu_torch.integrations import pennylane_device as port_pl
from rocquantum_tpu_torch.integrations import qiskit_provider as port_qiskit

AMP_TOL = 1e-5      # of max|amp|
PROB_TOL = 1e-6
FRACTION_TOL = 0.05
CPU = "cpu"


def _unitary(m, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(1 << m, 1 << m))
                        + 1j * rng.normal(size=(1 << m, 1 << m)))
    return q


def _same_state(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= AMP_TOL * np.max(np.abs(want))


# -- Qiskit -------------------------------------------------------------------

def _qiskit_circuit(n, seed, measure=None):
    """Every instruction the backend translates, then ``measure`` (qubit
    -> clbit pairs)."""
    rng = np.random.default_rng(seed)
    qc = QuantumCircuit(n, n)
    for q in range(n):
        qc.h(q)
        qc.ry(float(rng.normal()), q)
    qc.rx(0.3, 0)
    qc.rz(-0.8, n - 1)
    for q in range(n - 1):
        qc.cx(q, q + 1)
    qc.cz(0, n - 1)
    qc.swap(0, n - 2)
    for name in ("x", "y", "z", "s", "t"):
        getattr(qc, name)(int(rng.integers(0, n)))
    qc._add("sdg", [0])
    qc._add("tdg", [n - 1])
    qc.ccx(0, 1, 2)
    qc._add("cswap", [2, 0, 1])
    qc.unitary(_unitary(2, seed), [n - 1, 1])
    qc.barrier()
    for q, c in (measure or []):
        qc.measure(q, c)
    return qc


def _qiskit_backends():
    return (jax_qiskit.RocQuantumBackend(),
            port_qiskit.RocQuantumBackend(device=CPU))


@pytest.mark.parametrize("n", [3, 4, 6])
def test_qiskit_statevector_matches_jax(n):
    qc = _qiskit_circuit(n, n)
    jax_b, port_b = _qiskit_backends()
    jax_b.run(qc, shots=16)
    port_b.run(qc, shots=16)
    _same_state(port_b.get_statevector(), jax_b.get_statevector())


def test_qiskit_counts_layout_matches_jax():
    """Bit i of an outcome is the i-th measured qubit (clbit order); keys
    are zero-padded to the number measured; the Result dict has the JAX
    package's layout."""
    n = 5
    qc = QuantumCircuit(n, n)
    for q in (0, 3):
        qc.x(q)
    qc.measure([3, 1, 0], [0, 1, 2])
    jax_b, port_b = _qiskit_backends()
    want = jax_b.run(qc, shots=50)._d
    got = port_b.run(qc, shots=50)._d
    assert got.keys() == want.keys()
    assert got["results"][0].keys() == want["results"][0].keys()
    assert got["results"][0]["data"]["counts"] == {"101": 50}
    assert got["results"][0]["data"]["counts"] == \
        want["results"][0]["data"]["counts"]
    assert got["results"][0]["data"]["memory"] == ["101"] * 50
    assert got["results"][0]["header"] == want["results"][0]["header"]
    assert got["backend_name"] == "rocq_simulator"


def test_qiskit_counts_follow_the_marginal():
    n, shots = 4, 4000
    qc = _qiskit_circuit(n, 9, measure=[(0, 0), (2, 1)])
    _, port_b = _qiskit_backends()
    result = port_b.run(qc, shots=shots)
    counts = result.get_counts()
    assert sum(counts.values()) == shots
    assert all(len(k) == 2 and set(k) <= {"0", "1"} for k in counts)
    probs = np.abs(port_b.get_statevector()) ** 2
    k = np.arange(1 << n)
    marg = np.bincount(((k >> 0) & 1) | (((k >> 2) & 1) << 1),
                       weights=probs, minlength=4)
    for key, v in counts.items():
        assert abs(v / shots - marg[int(key, 2)]) <= FRACTION_TOL


def test_qiskit_measures_every_qubit_without_measure_instructions():
    qc = QuantumCircuit(3)
    qc.x(1)
    _, port_b = _qiskit_backends()
    assert port_b.run(qc, shots=8).get_counts() == {"010": 8}


def test_qiskit_reuses_the_simulator_across_equal_widths():
    _, port_b = _qiskit_backends()
    qc = QuantumCircuit(3)
    qc.x(0)
    port_b.run(qc, shots=4)
    sim = port_b._simulator
    qc2 = QuantumCircuit(3)
    qc2.h(2)
    port_b.run([qc2], shots=4)
    assert port_b._simulator is sim
    _same_state(port_b.get_statevector(),
                np.array([1, 0, 0, 0, 1, 0, 0, 0]) * 2 ** -0.5)
    port_b.run(QuantumCircuit(4), shots=4)
    assert port_b._simulator is not sim


def test_qiskit_rejects_what_jax_rejects():
    qc = QuantumCircuit(2)
    qc._add("u2", [0], [0.1, 0.2])
    for backend in _qiskit_backends():
        with pytest.raises(ValueError, match="Unsupported instruction: u2"):
            backend.run(qc)
    with pytest.raises(RuntimeError):
        port_qiskit.RocQuantumBackend(device=CPU).get_statevector()


def test_qiskit_provider():
    provider = port_qiskit.RocQuantumProvider(device=CPU)
    backend = provider.get_backend("rocq_simulator")
    assert provider.get_backend() is backend
    assert provider.backends() == [backend]
    assert provider.backends("rocq_simulator") == [backend]
    assert backend._device == torch.device(CPU)
    assert backend.options.shots == 1024 and backend.max_circuits is None


# -- Cirq ---------------------------------------------------------------------

def _cirq_circuit(n, seed):
    rng = np.random.default_rng(seed)
    qs = cirq.LineQubit.range(n)
    ops = []
    for q in qs:
        ops.append(cirq.H(q))
        ops.append(cirq.ry(float(rng.normal()))(q))
    for a, b in zip(qs, qs[1:]):
        ops.append(cirq.CNOT(a, b))
    ops += [cirq.CZ(qs[0], qs[-1]), cirq.X(qs[1]), cirq.Y(qs[0]),
            cirq.Z(qs[-1]), cirq.S(qs[1]), cirq.T(qs[0]),
            cirq.rx(0.7)(qs[-1])]
    return cirq.Circuit(ops), qs


@pytest.mark.parametrize("n", [2, 4, 6])
def test_cirq_final_state_matches_jax(n):
    circuit, _ = _cirq_circuit(n, n)
    (want,) = jax_cirq.RocQuantumSimulator().simulate_sweep(circuit)
    (got,) = port_cirq.RocQuantumSimulator(device=CPU).simulate_sweep(
        circuit)
    assert got.state_vector().dtype == np.complex64
    _same_state(got.state_vector(), want.state_vector())
    assert got.params == want.params


def test_cirq_run_bit_order_matches_jax():
    """Bit i of a measured row is the i-th measured qubit."""
    qs = cirq.LineQubit.range(5)
    circuit = cirq.Circuit([cirq.X(qs[1]), cirq.X(qs[4]),
                            cirq.measure(qs[4], qs[0], qs[1], key="a"),
                            cirq.measure(qs[2], key="b")])
    want = jax_cirq.RocQuantumSimulator()._run(
        circuit, cirq.ParamResolver({}), 7)
    got = port_cirq.RocQuantumSimulator(device=CPU)._run(
        circuit, cirq.ParamResolver({}), 7)
    assert got.keys() == want.keys() == {"a", "b"}
    for key in got:
        assert got[key].dtype == np.uint8
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["a"][0], [1, 0, 1])


# -- PennyLane ----------------------------------------------------------------

def _pl_ops(n, seed):
    rng = np.random.default_rng(seed)
    ops = []
    for w in range(n):
        ops.append(qml.RX(float(rng.normal()), wires=w))
        ops.append(qml.RY(float(rng.normal()), wires=w))
    for w in range(n - 1):
        ops.append(qml.CNOT(wires=[w, w + 1]))
    ops += [qml.RZ(0.4, wires=0), qml.Hadamard(wires=n - 1),
            qml.PauliX(wires=1), qml.PauliY(wires=0), qml.PauliZ(wires=1),
            qml.CZ(wires=[0, n - 1]), qml.Operation("S", 1),
            qml.Operation("T", 0),
            qml.QubitUnitary(_unitary(2, seed), wires=[n - 1, 0])]
    return ops


@pytest.mark.parametrize("n", [2, 3, 5])
def test_pennylane_state_and_probabilities_match_jax(n):
    ops = _pl_ops(n, n)
    jax_dev, port_dev = jax_pl.RocQDevice(wires=n), port_pl.RocQDevice(
        wires=n, device=CPU)
    assert port_dev.state is None and port_dev.analytic_probability() is None
    jax_dev.apply(ops)
    port_dev.apply(ops)
    _same_state(port_dev.state, jax_dev.state)
    full = port_dev.analytic_probability()
    assert full.shape == (1 << n,)
    np.testing.assert_allclose(full, jax_dev.analytic_probability(),
                               atol=PROB_TOL)
    for wires in ([0], [n - 1, 0], list(range(n))):
        np.testing.assert_allclose(port_dev.analytic_probability(wires),
                                   jax_dev.analytic_probability(wires),
                                   atol=PROB_TOL)


def test_pennylane_samples_shape_wire_order_and_seed():
    """(shots, n) samples whose column j is the marginal of wire j under
    the base class's wire order; equal seeds give equal draws."""
    n, shots = 3, 4000
    ops = _pl_ops(n, 11)
    devs = [port_pl.RocQDevice(wires=n, shots=shots, device=CPU)
            for _ in range(2)]
    for dev in devs:
        dev.apply(ops)
    samples = devs[0].generate_samples()
    assert samples.shape == (shots, n)
    np.testing.assert_array_equal(samples, devs[1].generate_samples())
    for w in range(n):
        p1 = devs[0].analytic_probability([w])[1]
        assert abs(samples[:, w].mean() - p1) <= FRACTION_TOL


def test_pennylane_rejects_unsupported_operations():
    for dev in (jax_pl.RocQDevice(wires=1),
                port_pl.RocQDevice(wires=1, device=CPU)):
        with pytest.raises(NotImplementedError, match="Toffoli"):
            dev.apply([qml.Operation("Toffoli", [0])])


# -- the JAX package's six plugin cases, on the port ---------------------------

def test_port_qiskit_bell_counts_and_statevector():
    backend = port_qiskit.RocQuantumProvider(device=CPU).get_backend(
        "rocq_simulator")
    qc = QuantumCircuit(2, 2)
    qc.h(0)
    qc.cx(0, 1)
    qc.measure([0, 1], [0, 1])
    counts = backend.run(qc, shots=1000).get_counts()
    assert set(counts) <= {"00", "11"}
    assert abs(counts.get("00", 0) / sum(counts.values()) - 0.5) < 0.1


def test_port_qiskit_rz_phase():
    backend = port_qiskit.RocQuantumBackend(device=CPU)
    qc = QuantumCircuit(1)
    qc.h(0)
    qc.rz(np.pi / 2, 0)
    backend.run(qc, shots=10)
    psi = backend.get_statevector()
    assert abs(psi[1] / psi[0] - 1j) < 1e-5


def test_port_cirq_bell():
    q0, q1 = cirq.LineQubit.range(2)
    circuit = cirq.Circuit([cirq.H(q0), cirq.CNOT(q0, q1),
                            cirq.measure(q0, q1, key="m")])
    bits = port_cirq.RocQuantumSimulator(device=CPU)._run(
        circuit, cirq.ParamResolver({}), repetitions=500)["m"]
    assert set((bits[:, 0] ^ bits[:, 1]).tolist()) == {0}


def test_port_pennylane_bell_state():
    dev = port_pl.RocQDevice(wires=2, device=CPU)
    dev.apply([qml.Hadamard(wires=0), qml.CNOT(wires=[0, 1])])
    assert abs(abs(dev.state[0]) - 2 ** -0.5) < 1e-5
    assert abs(abs(dev.state[3]) - 2 ** -0.5) < 1e-5


def test_port_pennylane_rx_probability_and_samples():
    theta = 0.9
    dev = port_pl.RocQDevice(wires=1, shots=4000, device=CPU)
    dev.apply([qml.RX(theta, wires=0)])
    assert abs(dev.analytic_probability()[1] - np.sin(theta / 2) ** 2) < 1e-5
    samples = dev.generate_samples()
    assert samples.shape == (4000, 1)
    assert abs(samples.mean() - np.sin(theta / 2) ** 2) < 0.05


def test_port_pennylane_qubit_unitary_fallback():
    dev = port_pl.RocQDevice(wires=1, device=CPU)
    dev.apply([qml.QubitUnitary(np.array([[0, 1], [1, 0]], dtype=complex),
                                wires=0)])
    assert abs(abs(dev.state[1]) - 1.0) < 1e-5


# -- no fallback hides the card --------------------------------------------------

def test_plugins_need_cuda_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (port_qiskit.RocQuantumBackend,
                 port_qiskit.RocQuantumProvider,
                 port_cirq.RocQuantumSimulator,
                 lambda: port_pl.RocQDevice(wires=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
