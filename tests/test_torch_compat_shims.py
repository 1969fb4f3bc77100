"""The port's reference-name shims (``rocquantum_tpu_torch.compat``) against
the JAX package's (the repository's ``rocq``, ``rocquantum``,
``rocquantum_bind``, ``rocq_hip`` and ``rocq._rocq_hip_backend``): every
case of tests/test_compat_shims.py, driven the same way on both, with the
port on the CPU (``device="cpu"`` where the reference's signature has no
place for it) and its values held to the JAX shims' within those tests'
tolerances.
"""

import sys

import numpy as np

import rocq as jrocq
import rocq._rocq_hip_backend as jbe
import rocq_hip as jrocq_hip
import rocquantum as jrocquantum
import rocquantum_bind as jbind
from rocquantum_tpu_torch.compat import _rocq_hip_backend as pbe
from rocquantum_tpu_torch.compat import rocq as procq
from rocquantum_tpu_torch.compat import rocq_hip as procq_hip
from rocquantum_tpu_torch.compat import rocquantum as procquantum
from rocquantum_tpu_torch.compat import rocquantum_bind as pbind

CPU = "cpu"
TOL = 1e-6


def test_the_shims_claim_no_reference_name():
    for name in ("rocq", "rocquantum", "rocquantum_bind", "rocq_hip"):
        assert not getattr(sys.modules.get(name), "__name__", name).startswith(
            "rocquantum_tpu_torch")
    assert procq._rocq_hip_backend is pbe


class TestRocqShim:
    def test_dsl_surface(self):
        states = []
        for rocq, kw in ((jrocq, {}), (procq, {"device": CPU})):
            noise = rocq.NoiseModel()
            noise.add_channel("depolarizing", 0.01)

            @rocq.kernel
            def bell():
                q = rocq.qvec(2)
                rocq.h(q[0])
                rocq.cnot(q[0], q[1])

            states.append(np.asarray(rocq.execute(bell,
                                                  backend="state_vector",
                                                  **kw)))
        assert abs(abs(states[1][0]) - 2**-0.5) < TOL
        np.testing.assert_allclose(states[1], states[0], atol=TOL)

    def test_api_surface(self):
        psis = []
        for api, kw in ((jrocq.api, {}), (procq.api, {"device": CPU})):
            c = api.Circuit(2, api.Simulator(**kw))
            c.h(0)
            c.cx(0, 1)
            psis.append(c.get_statevector())
        assert abs(abs(psis[1][3]) - 2**-0.5) < TOL
        np.testing.assert_allclose(psis[1], psis[0], atol=TOL)

    def test_mixed_surface_sampling_example_style(self):
        for rocq, kw in ((jrocq, {}), (procq, {"device": CPU})):
            circuit = rocq.Circuit(2, rocq.Simulator(**kw))
            circuit.h(0)
            circuit.cx(0, 1)
            results = circuit.sample([0, 1], 500)
            assert set(np.unique(results)) <= {0, 3}

    def test_pauli_operator_both_forms(self):
        for rocq in (jrocq, procq):
            a = rocq.PauliOperator("Z0 Z1")
            b = rocq.PauliOperator({"X0": 0.5})
            c = rocq.PauliOperator("X0 Y1", 0.25)
            assert a.terms[0][1] == 1.0
            assert b.terms[0][1] == 0.5
            assert c.terms == [([("X", 0), ("Y", 1)], 0.25)]

    def test_dsl_expectation_with_api_operator(self):
        vals = []
        for rocq, kw in ((jrocq, {}), (procq, {"device": CPU})):
            @rocq.kernel
            def plus():
                q = rocq.qvec(1)
                rocq.h(q[0])

            vals.append(rocq.get_expectation_value(
                plus, rocq.PauliOperator("X0"), backend="state_vector", **kw))
        assert abs(vals[1] - 1.0) < TOL and abs(vals[1] - vals[0]) < TOL


class TestRocquantumShim:
    def test_vqe_h2_style_usage(self):
        out = []
        for rocq, kw in ((jrocquantum, {}), (procquantum, {"device": CPU})):
            @rocq.kernel
            def ansatz(params):
                rocq.ry(params[0], 0)
                rocq.ry(params[1], 1)
                rocq.cnot(0, 1)

            out.append((rocq.get_expval(ansatz, "ZZ", [0.0, 0.0], **kw),
                        rocq.grad(ansatz, "ZZ", [0.3, 0.2], **kw)))
        (jv, jg), (pv, pg) = out
        assert abs(pv - 1.0) < TOL and abs(pv - jv) < TOL
        # CNOT(0->1) conjugates Z0Z1 to Z1: <ZZ> = cos(t1)
        assert abs(pg[0]) < 1e-5 and abs(pg[1] + np.sin(0.2)) < 1e-5
        np.testing.assert_allclose(pg, jg, atol=1e-5)

    def test_submodules(self):
        qasm = []
        for rq in (jrocquantum, procquantum):
            c = rq.circuit.QuantumCircuit(2)
            c.h(0)
            c.cx(0, 1)
            qasm.append(c.to_qasm())
            assert rq.QuantumCircuit is rq.circuit.QuantumCircuit
        assert "OPENQASM" in qasm[1] and qasm[1] == qasm[0]
        procquantum.set_target("local", device=CPU)
        assert procquantum.get_active_backend() is not None
        assert procquantum.core.get_active_backend() is \
            procquantum.get_active_backend()

    def test_python_rocq_import_path(self):
        # reference qec/framework.py:19 import path
        import rocquantum.python.rocq as jroc_q
        roc_q = procquantum.python.rocq
        sim = roc_q.Simulator(device=CPU)
        assert isinstance(sim, roc_q.Simulator)
        assert isinstance(jroc_q.Simulator(), jroc_q.Simulator)

    def test_solvers_via_shim(self):
        for rq in (jrocquantum, procquantum):
            assert rq.solvers.VQE_Solver.__name__ == "VQE_Solver"
            assert rq.qec.ThreeQubitRepetitionCode.__name__ == \
                "ThreeQubitRepetitionCode"
            assert callable(rq.utils.compute_hamiltonian_expectation)


class TestBindingShims:
    def test_rocquantum_bind(self):
        psis = []
        for bind, kw in ((jbind, {}), (pbind, {"device": CPU})):
            sim = bind.QSim(2, **kw)
            sim.ApplyGate("H", 0)
            sim.ApplyCNOT(0, 1)
            sim.Execute()
            psis.append(np.asarray(sim.GetStateVector()))
            comp = bind.MLIRCompiler(num_qubits=2)
            assert comp.initialize_module("m", 2)
        assert abs(abs(psis[1][0]) - 2**-0.5) < TOL
        np.testing.assert_allclose(psis[1], psis[0], atol=TOL)

    def test_rocq_hip(self):
        vals = []
        for hip, kw in ((jrocq_hip, {}), (procq_hip, {"device": CPU})):
            st = hip.DensityMatrixState(1, **kw)
            st.apply_h(0)
            vals.append(st.compute_expectation(hip.Pauli.X, 0))
        assert abs(vals[1] - 1.0) < TOL and abs(vals[1] - vals[0]) < TOL

    def test_rocq_hip_backend_tensornet(self):
        results = []
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            tensor0 = be.RocTensor([2, 2, 2, 16], py_data_np_array=None)
            tensor0.labels = ["a", "b", "c", "d"]
            tensor1 = be.RocTensor([16, 2, 2, 16], py_data_np_array=None)
            tensor1.labels = ["d", "e", "f", "g"]
            tensor2 = be.RocTensor([16, 2, 2, 2], py_data_np_array=None)
            tensor2.labels = ["g", "h", "i", "j"]
            result = be.RocTensor([], py_data_np_array=None)
            tn = be.RocTensorNetwork(be.RocsvHandle(**kw))
            for t in (tensor0, tensor1, tensor2):
                be.rocTensorNetworkAddTensor(tn, t)
            tn.contract({"repetitions": 8, "memory_limit": 2048}, result)
            assert tn.last_num_slices > 1
            assert result._data is not None
            results.append((tn.last_num_slices, result.labels,
                            np.asarray(result._data)))
        (js, jl, jd), (ps, pl, pd) = results
        assert ps == js and list(pl) == list(jl)
        scale = float(np.abs(jd).max())
        assert float(np.abs(pd - jd).max()) <= 1e-5 * scale


class TestB1PerGateSurface:
    """The reference's binding layer (python/rocq/bindings.cpp:160-495)
    driven as reference user code drives it, on both packages."""

    @staticmethod
    def _bell(be, **kw):
        h = be.RocsvHandle(**kw)
        d = be.allocate_state_internal(h, 2)
        assert be.initialize_state(h, d, 2) == be.rocqStatus.SUCCESS
        assert be.apply_h(h, d, 2, 0) == be.rocqStatus.SUCCESS
        assert be.apply_cnot(h, d, 2, 0, 1) == be.rocqStatus.SUCCESS
        return h, d

    def test_bell_flow_statevector_and_sampling(self):
        svs = []
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            h, d = self._bell(be, **kw)
            svs.append(be.get_state_vector_full(h, d, 2))
            shots = 2000
            results = be.sample(h, d, 2, [0, 1], shots)
            assert results.dtype == np.uint64 and len(results) == shots
            counts = {int(v): int(c) for v, c in
                      zip(*np.unique(results, return_counts=True))}
            assert set(counts) <= {0, 3}
            assert abs(counts.get(0, 0) - shots / 2) < shots / 10
        expected = np.zeros(4, np.complex64)
        expected[0] = expected[3] = 2**-0.5
        assert np.allclose(svs[1], expected, atol=TOL)
        np.testing.assert_allclose(svs[1], svs[0], atol=TOL)

    def test_every_named_gate_enqueues(self):
        psis = []
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            h = be.RocsvHandle(**kw)
            d = be.allocate_state_internal(h, 4)
            S = be.rocqStatus.SUCCESS
            assert be.apply_x(h, d, 4, 0) == S
            assert be.apply_y(h, d, 4, 1) == S
            assert be.apply_z(h, d, 4, 2) == S
            assert be.apply_s(h, d, 4, 0) == S
            assert be.apply_sdg(h, d, 4, 0) == S
            assert be.apply_t(h, d, 4, 1) == S
            assert be.apply_rx(h, d, 4, 0, 0.3) == S
            assert be.apply_ry(h, d, 4, 1, 0.4) == S
            assert be.apply_rz(h, d, 4, 2, 0.5) == S
            assert be.apply_cz(h, d, 4, 0, 1) == S
            assert be.apply_swap(h, d, 4, 1, 2) == S
            assert be.apply_crx(h, d, 4, 0, 1, 0.2) == S
            assert be.apply_cry(h, d, 4, 1, 2, 0.2) == S
            assert be.apply_crz(h, d, 4, 2, 3, 0.2) == S
            assert be.apply_mcx(h, d, 4, [0, 1], 3) == S
            assert be.apply_cswap(h, d, 4, 0, 1, 2) == S
            psis.append(be.get_state_vector_full(h, d, 4))
        assert abs(np.linalg.norm(psis[1]) - 1.0) < 1e-5
        np.testing.assert_allclose(psis[1], psis[0], atol=1e-5)

    def test_apply_matrix_and_controlled_matrix(self):
        psis = []
        H = (np.array([[1, 1], [1, -1]]) / np.sqrt(2)).astype(np.complex64)
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            h = be.RocsvHandle(**kw)
            d = be.allocate_state_internal(h, 2)
            mat = be.create_device_matrix_from_numpy(H)
            assert mat.nbytes() == H.nbytes
            be.apply_matrix(h, d, 2, [0], mat, 2)
            X = be.create_device_matrix_from_numpy(
                np.array([[0, 1], [1, 0]], np.complex64))
            be.apply_controlled_matrix(h, d, 2, [0], [1], X)
            psis.append(be.get_state_vector_full(h, d, 2))
        expected = np.zeros(4, np.complex64)
        expected[0] = expected[3] = 2**-0.5
        assert np.allclose(psis[1], expected, atol=TOL)
        np.testing.assert_allclose(psis[1], psis[0], atol=TOL)

    def test_measure_collapses(self):
        outs = []
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            h, d = self._bell(be, **kw)
            outcome, prob = be.measure(h, d, 2, 0)
            assert outcome in (0, 1) and abs(prob - 0.5) < TOL
            # post-collapse the two qubits are perfectly correlated
            o2, p2 = be.measure(h, d, 2, 1)
            assert o2 == outcome and abs(p2 - 1.0) < TOL
            outs.append((outcome, o2))
        # one seed, one host stream: the same outcomes
        assert outs[1] == outs[0]

    def test_expectations(self):
        vals = []
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            h, d = self._bell(be, **kw)
            v = [be.get_expectation_value_z(h, d, 2, 0),
                 be.get_expectation_value_x(h, d, 2, 0),
                 be.get_expectation_value_y(h, d, 2, 1),
                 be.get_expectation_value_pauli_product_z(h, d, 2, [0, 1]),
                 be.get_expectation_pauli_string(h, d, 2, "XX", [0, 1]),
                 be.get_expectation_value_pauli_product_z(h, d, 2, [])]
            d2 = be.allocate_state_internal(h, 1)
            be.apply_h(h, d2, 1, 0)
            v.append(be.get_expectation_value_x(h, d2, 1, 0))
            vals.append(v)
        np.testing.assert_allclose(vals[1], [0, 0, 0, 1, 1, 1, 1], atol=TOL)
        np.testing.assert_allclose(vals[1], vals[0], atol=TOL)

    def test_state_vector_slice(self):
        for be, kw in ((jbe, {}), (pbe, {"device": CPU})):
            h, d = self._bell(be, **kw)
            full = be.get_state_vector_full(h, d, 2)
            sl = be.get_state_vector_slice(h, d, 2, 1, 0)
            assert np.allclose(full, sl)


def test_pinned_buffer_family():
    """hipStateVec.h:296-325: grow-only ensure, pointer readback, free, as
    the JAX shim does it."""
    for b, kw in ((jbe, {}), (pbe, {"device": CPU})):
        h = b.RocsvHandle(**kw)
        assert b.rocsv_get_pinned_buffer_pointer(h) is None
        assert b.rocsv_ensure_pinned_buffer(h, 1024) is b.rocqStatus.SUCCESS
        buf = b.rocsv_get_pinned_buffer_pointer(h)
        assert buf.nbytes == 1024
        assert b.rocsv_ensure_pinned_buffer(h, 512) is b.rocqStatus.SUCCESS
        assert b.rocsv_get_pinned_buffer_pointer(h) is buf
        assert b.rocsv_ensure_pinned_buffer(h, 2048) is b.rocqStatus.SUCCESS
        assert b.rocsv_get_pinned_buffer_pointer(h).nbytes == 2048
        assert b.rocsv_free_pinned_buffer(h) is b.rocqStatus.SUCCESS
        assert b.rocsv_get_pinned_buffer_pointer(h) is None
        assert (b.rocsv_ensure_pinned_buffer(h, -1)
                is b.rocqStatus.ERROR_INVALID_VALUE)


def test_handle_and_distributed_state_on_the_port():
    """Simulator.handle, next_key and allocate_distributed_state (a plain
    state where the default mesh has one device or none)."""
    sim = procq.Simulator(seed=3, device=CPU)
    assert sim.handle.simulator is sim and sim.handle is sim.handle
    assert sim.handle.get_num_gpus() == 0  # no CUDA device here
    a, b = sim.next_key(), sim.next_key()
    import torch
    x = torch.rand(4, generator=a, dtype=torch.float64)
    y = torch.rand(4, generator=b, dtype=torch.float64)
    assert not torch.equal(x, y)
    again = procq.Simulator(seed=3, device=CPU).next_key()
    assert torch.equal(torch.rand(4, generator=again, dtype=torch.float64), x)
    h = pbe.RocsvHandle(device=CPU)
    d = pbe.allocate_distributed_state(h, 3)
    assert d.circuit.mesh is None
    assert pbe.initialize_distributed_state(h, d) == pbe.rocqStatus.SUCCESS
    assert abs(d.to_numpy()[0] - 1.0) < TOL
