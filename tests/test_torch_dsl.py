"""The port's rocq DSL, model builders, Trotter evolution and Hamiltonian
helpers against the JAX package's, and the asserted outcomes of five
examples run against the port.

Kernels are recorded by each package's own ``dsl`` from the same Python
body and executed on both backends in ``"single"`` and ``"double"``. The
JAX side runs its kernels in Pallas interpret mode (N = 15 plans kernel
blocks on both sides). Tolerances: single precision within 1e-5 (of
max|amp| for states), double within 1e-12, draws within 0.03 of the
probabilities.
"""

import jax
import numpy as np
import pytest
from scipy.optimize import minimize

import rocquantum_tpu as rocq_jax
from rocquantum_tpu import config as jax_config
from rocquantum_tpu import dsl as jax_dsl
from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.density_state import DensityMatrixState as JaxDMState
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.models import evolution as jax_evolution
from rocquantum_tpu.ops import statevec as jsv
from rocquantum_tpu.utils.hamiltonian import (
    compute_hamiltonian_expectation as jax_hamiltonian)
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch import dsl
from rocquantum_tpu_torch.compiler import Compiler
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.core import get_active_backend, set_target
from rocquantum_tpu_torch.models import circuits, evolution
from rocquantum_tpu_torch.ops import fused_sv
from rocquantum_tpu_torch.ops import statevec as sv
from rocquantum_tpu_torch.qcircuit import QuantumCircuit
from rocquantum_tpu_torch.utils import compute_hamiltonian_expectation

N = 15
F32_TOL = 1e-5
F64_TOL = 1e-12
FREQ_TOL = 0.03


@pytest.fixture(autouse=True)
def interpret_and_restore(monkeypatch):
    monkeypatch.setenv("ROCQ_PALLAS_INTERPRET", "1")
    jax_interp.clear_cache()
    interpreter.clear_cache()
    old = (jax_config.get_precision(), port_config.get_precision(),
           jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    port_config.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])
    jax_interp.clear_cache()
    interpreter.clear_cache()


def _set_precision(precision):
    jax_config.set_precision(precision)
    port_config.set_precision(precision)
    return F64_TOL if precision == "double" else F32_TOL


def _kernels(d):
    """The same kernel bodies recorded by the DSL module ``d``."""

    @d.kernel
    def bell():
        q = d.qvec(2)
        d.h(q[0])
        d.cnot(q[0], q[1])

    @d.kernel
    def mixed(theta, phi):
        q = d.qvec(4)
        d.h(q[0])
        d.rx(theta, q[1])
        d.ry(2.0 * phi, q[2])
        d.rz(phi - 0.3, q[3])
        d.s(q[0])
        d.sdg(q[2])
        d.t(q[1])
        d.tdg(q[3])
        d.y(q[0])
        d.z(q[1])
        d.x(q[3])
        d.cx(q[0], q[2])
        d.cz(q[1], q[3])
        d.swap(q[0], q[3])
        d.ccx(q[0], q[1], q[2])
        d.mcx([q[3], q[2], q[1]], q[0])
        d.rx(-theta, q[2])

    @d.kernel
    def direct(t0, t1):  # raw qubit indices, no qvec (examples/vqe_h2.py)
        d.ry(t0, 0)
        d.ry(t1, 1)
        d.cnot(0, 1)

    return {"bell": (bell, {}), "mixed": (mixed, {"theta": 0.7, "phi": -0.4}),
            "direct": (direct, {"t0": 0.3, "t1": 1.2})}


JAX_KERNELS = _kernels(jax_dsl)
PORT_KERNELS = _kernels(dsl)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * max(float(np.max(np.abs(ref))), 1e-30), err


@pytest.mark.parametrize("name", list(PORT_KERNELS))
def test_kernel_recording_matches(name):
    (ref, _), (got, _) = JAX_KERNELS[name], PORT_KERNELS[name]
    assert got.name == ref.name and got.num_qubits == ref.num_qubits
    assert got.param_names == ref.param_names
    assert [(g["op"], g["targets"], sorted(g["params"]))
            for g in got.gate_sequence] == \
        [(g["op"], g["targets"], sorted(g["params"]))
         for g in ref.gate_sequence]
    bindings = {"theta": 0.7, "phi": -0.4, "t0": 0.3, "t1": 1.2}
    assert got.bound_sequence(bindings) == ref.bound_sequence(bindings)
    if name == "bell":
        assert got.mlir() == ref.mlir()
        assert got.qir() == ref.qir()
        assert _ir(got.ir()) == _ir(ref.ir())
    with pytest.raises(NotImplementedError):
        got.stablehlo()
    assert repr(got) == repr(ref)


def _ir(ir):
    return (ir.num_qubits, ir.name,
            [(op.name, op.targets, op.controls, op.params) for op in ir.ops])


def test_dsl_contract_errors():
    with pytest.raises(ValueError):
        dsl.qvec(0)
    with pytest.raises(RuntimeError):
        dsl.h(0)
    bell, _ = PORT_KERNELS["bell"]
    with pytest.raises(ValueError, match="Unsupported backend 'nope'"):
        dsl.execute(bell, backend="nope", device="cpu")
    noise = dsl.NoiseModel()
    noise.add_channel("depolarizing", 0.1)
    with pytest.raises(NotImplementedError):
        dsl.execute(bell, noise_model=noise, device="cpu")
    with pytest.raises(TypeError):
        dsl.execute(lambda: None, device="cpu")
    mixed, _ = PORT_KERNELS["mixed"]
    with pytest.raises(ValueError, match="was not bound"):
        dsl.execute(mixed, device="cpu", theta=0.1)
    with pytest.raises(ValueError):
        dsl.get_backend("density_matrix", 1, device="cpu").apply_noise(
            "nonsense", [0], 0.1)


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("backend", ["state_vector", "density_matrix"])
@pytest.mark.parametrize("name", list(PORT_KERNELS))
def test_execute_matches(name, backend, precision):
    tol = _set_precision(precision)
    (ref_k, binds), (got_k, _) = JAX_KERNELS[name], PORT_KERNELS[name]
    ref = jax_dsl.execute(ref_k, backend=backend, **binds)
    got = dsl.execute(got_k, backend=backend, device="cpu", **binds)
    assert got.dtype == np.complex128
    _close(got, ref, tol)


@pytest.mark.parametrize("backend", ["state_vector", "density_matrix"])
def test_execute_shots(backend):
    (ref_k, binds), (got_k, _) = JAX_KERNELS["mixed"], PORT_KERNELS["mixed"]
    shots = 20000
    got = dsl.execute(got_k, backend=backend, shots=shots, seed=3,
                      device="cpu", **binds)
    assert got.dtype == np.int32 and got.shape == (shots,)
    state = dsl.execute(got_k, backend=backend, device="cpu", **binds)
    probs = np.abs(state) ** 2 if state.ndim == 1 else np.real(
        np.diag(state))
    freq = np.bincount(got, minlength=16) / shots
    assert np.max(np.abs(freq - probs)) <= FREQ_TOL
    ref = jax_dsl.execute(ref_k, backend=backend, shots=shots, seed=3,
                          **binds)
    assert np.asarray(ref).dtype == np.int32


def _operators(d):
    return [d.PauliOperator("Z0"), d.PauliOperator("X0 X1", 0.5),
            d.PauliOperator("Y1 Z3 X2", -0.25),
            d.PauliOperator("Z0") + 0.3 * d.PauliOperator("Y0 Y2")
            + d.PauliOperator("X3"),
            d.HermitianOperator(np.array([[1.0, 0.5 - 0.2j],
                                          [0.5 + 0.2j, -0.4]]),
                                targets=[2]),
            2.0 * d.HermitianOperator(np.diag([1.0, -1.0, 0.5, 0.25]),
                                      targets=[3, 1])]


def _exact_expectation(operator, state, n):
    """<operator> of a JAX-side state (a vector or rho) in complex128: the
    reference for HermitianOperator, whose JAX path fails under
    ``set_precision("double")`` (its backends return a (re, im) pair
    there)."""
    m = np.asarray(operator.matrix, np.complex128)
    targets = list(operator.targets)
    full = np.zeros((1 << n, 1 << n), np.complex128)
    for col in range(1 << n):
        sub = sum(((col >> t) & 1) << j for j, t in enumerate(targets))
        rest = col & ~sum(1 << t for t in targets)
        for row_sub in range(1 << len(targets)):
            row = rest | sum(((row_sub >> j) & 1) << t
                             for j, t in enumerate(targets))
            full[row, col] = m[row_sub, sub]
    value = np.vdot(state, full @ state) if state.ndim == 1 \
        else np.trace(full @ state)
    return float(operator.coefficient.real) * float(np.real(value))


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("backend", ["state_vector", "density_matrix"])
def test_expectation_values_match(backend, precision):
    tol = _set_precision(precision)
    (ref_k, binds), (got_k, _) = JAX_KERNELS["mixed"], PORT_KERNELS["mixed"]
    ref_state = jax_dsl.execute(ref_k, backend=backend, **binds)
    for ref_op, got_op in zip(_operators(jax_dsl), _operators(dsl)):
        assert got_op.to_string() == ref_op.to_string()
        got = dsl.get_expectation_value(got_k, got_op, backend,
                                        device="cpu", **binds)
        assert isinstance(got, float)
        if isinstance(got_op, dsl.HermitianOperator):
            ref = _exact_expectation(got_op, ref_state, 4)
            if precision == "single":
                assert abs(jax_dsl.get_expectation_value(
                    ref_k, ref_op, backend, **binds) - ref) <= tol
        else:
            ref = jax_dsl.get_expectation_value(ref_k, ref_op, backend,
                                                **binds)
        assert abs(got - ref) <= tol * max(1.0, abs(ref)), (got_op, got, ref)
    # the main API's PauliOperator (a list of terms) is taken too
    ref_h = rocq_jax.PauliOperator({"Z0 Z1": 0.5, "X2": -1.0, "I": 0.25})
    got_h = rq.PauliOperator({"Z0 Z1": 0.5, "X2": -1.0, "I": 0.25})
    ref = jax_dsl.get_expectation_value(ref_k, ref_h, backend, **binds)
    got = dsl.get_expectation_value(got_k, got_h, backend, device="cpu",
                                    **binds)
    assert abs(got - ref) <= tol * max(1.0, abs(ref))


@pytest.mark.parametrize("precision", ["single", "double"])
def test_noise_model_on_the_density_backend(precision):
    tol = _set_precision(precision)
    out = []
    for d, (k, binds) in ((jax_dsl, JAX_KERNELS["direct"]),
                          (dsl, PORT_KERNELS["direct"])):
        noise = d.NoiseModel()
        noise.add_channel("depolarizing", 0.02)
        noise.add_channel("bit_flip", 0.05, after_op="cnot")
        noise.add_channel("amplitude_damping", 0.1, on_qubits=[1],
                          after_op="ry")
        noise.add_channel("phase_flip", 0.03, on_qubits=[0],
                          after_op="cnot")
        kwargs = {} if d is jax_dsl else {"device": "cpu"}
        rho = d.execute(k, backend="density_matrix", noise_model=noise,
                        **kwargs, **binds)
        energy = d.get_expectation_value(
            k, d.PauliOperator("Z0 Z1") + d.PauliOperator("X1", 0.5),
            "density_matrix", noise_model=noise, **kwargs, **binds)
        out.append((rho, energy))
    (ref_rho, ref_e), (rho, e) = out
    _close(rho, ref_rho, tol)
    assert abs(e - ref_e) <= tol
    assert abs(np.trace(rho) - 1.0) <= tol
    assert np.max(np.abs(rho - rho.conj().T)) <= tol


def test_state_vector_kernel_at_kernel_width(monkeypatch):
    """At N = 15 the kernel's expectations against ones summed in
    complex128 from the JAX package's state (its own readout sums in
    float32 and is 2.7e-5 off the exact <X7> here; the port's float64
    sums are 9e-8 off)."""
    calls = []
    wrapped = fused_sv.apply_fused_layer
    monkeypatch.setattr(fused_sv, "apply_fused_layer",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))

    def ring(d):
        @d.kernel
        def ansatz(theta):
            q = d.qvec(N)
            for i in range(N):
                d.ry(theta * (i + 1), q[i])
            for i in range(N):
                d.cnot(q[i], q[(i + 1) % N])
        return ansatz

    ref_state = convert.state_from_reference(
        jax_dsl.execute(ring(jax_dsl), theta=0.11), device="cpu")
    for term in ([("Z", 0), ("Z", 1)], [("X", 7)], [("Y", 2), ("X", 9)]):
        text = " ".join(f"{p}{q}" for p, q in term)
        got = dsl.get_expectation_value(ring(dsl), dsl.PauliOperator(text),
                                        "state_vector", device="cpu",
                                        theta=0.11)
        ref = float(sv.expval_pauli_string(ref_state, term))
        assert abs(got - ref) <= F32_TOL, (term, got, ref)
    assert calls, "no kernel pass ran"


MODEL_BUILDS = [
    ("qft_ir", (5,), {}), ("qft_ir", (4,), {"include_swaps": False}),
    ("ghz_ir", (6,), {}), ("hardware_efficient_ansatz_ir", (4, 2), {}),
    ("hardware_efficient_ansatz_ir", (5, 1), {"entangler": "linear"}),
    ("qaoa_maxcut_ir", (6, 2), {}),
    ("qaoa_maxcut_ir", (4, 1), {"edges": [(0, 2), (1, 3), (0, 3)]}),
    ("random_circuit_ir", (7, 5, 3), {}),
    ("random_circuit_ir", (5, 4, 1), {"two_qubit_prob": 0.7}),
    ("inverse_qft_ir", (5,), {}),
    ("inverse_qft_ir", (6,), {"qubits": [1, 3, 4]}),
    ("qpe_ir", (5, 13 / 32), {}), ("grover_ir", (4, 9), {}),
    ("grover_ir", (3, 2), {"iterations": 1})]


@pytest.mark.parametrize("build", MODEL_BUILDS,
                         ids=lambda b: f"{b[0]}{b[1]}{sorted(b[2])}")
def test_model_builders_give_the_same_ir(build):
    name, args, kwargs = build
    ref = getattr(jax_circuits, name)(*args, **kwargs)
    got = getattr(circuits, name)(*args, **kwargs)
    assert _ir(got) == _ir(convert.ir_from_reference(ref))
    assert got.num_params == ref.num_params
    with pytest.raises(ValueError):
        circuits.grover_ir(3, 8)


def _tfim(module, n):
    terms = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    terms.update({f"X{q}": -0.5 for q in range(n)})
    terms["Y0 Y2"] = 0.2
    return module.PauliOperator(terms)


@pytest.mark.parametrize("order,steps", [(1, 3), (2, 2)])
def test_trotter_ir_and_evolve(order, steps):
    n = 5
    ref_ir, ref_pf = jax_evolution.trotter_ir(_tfim(rocq_jax, n), n, steps,
                                              order)
    got_ir, got_pf = evolution.trotter_ir(_tfim(rq, n), n, steps, order)
    assert _ir(got_ir) == _ir(convert.ir_from_reference(ref_ir))
    np.testing.assert_array_equal(got_pf(0.7), ref_pf(0.7))
    x = 5
    ref = np.asarray(jax_evolution.evolve(jsv.basis_state(n, x),
                                          _tfim(rocq_jax, n), 0.7, steps,
                                          order))
    got = evolution.evolve(sv.basis_state(n, x, device="cpu"), _tfim(rq, n),
                           0.7, steps, order)
    _close(got.numpy(), ref, F32_TOL)
    with pytest.raises(ValueError):
        evolution.trotter_ir(_tfim(rq, n), n, 1, 3)


def test_evolve_at_kernel_width_matches():
    terms = {"Z0 Z1": -1.0, "X3": -0.5, "Y5 Y14": 0.2}
    x = 0x2A5F
    ref = np.asarray(jax_evolution.evolve(
        jsv.basis_state(N, x), rocq_jax.PauliOperator(terms), 0.3, 1, 2))
    got = evolution.evolve(sv.basis_state(N, x, device="cpu"),
                           rq.PauliOperator(terms), 0.3, 1, 2)
    _close(got.numpy(), ref, F32_TOL)


def test_hamiltonian_utils():
    ref, got = JaxDMState(3), rq.DensityMatrixState(3, device="cpu")
    for st in (ref, got):
        st.apply_h(0)
        st.apply_cnot(0, 1)
        st.apply_ry(0.4, 2)
        st.apply_depolarizing_channel([2], 0.1)
    ham = [("ZZI", 0.5), ("XXI", 0.25), ("IIY", -0.3), ("IXZ", 0.7),
           ("III", 1.0), ("", 0.1)]
    want = jax_hamiltonian(ham, ref)
    assert abs(compute_hamiltonian_expectation(ham, got) - want) <= F32_TOL
    with pytest.raises(ValueError):
        compute_hamiltonian_expectation([("Q", 1.0)], got)
    with pytest.raises(ValueError):
        compute_hamiltonian_expectation([("X" * 65, 1.0)], got)


def test_create_device_matrix():
    sim = rq.Simulator(device="cpu")
    m = sim.create_device_matrix(np.array([[0, 1j], [1, 0.5]]))
    assert m.dtype == port_config.complex_dtype() and m.device.type == "cpu"
    np.testing.assert_allclose(m.numpy(), [[0, 1j], [1, 0.5]])
    with pytest.raises(TypeError):
        sim.create_device_matrix([[1, 0], [0, 1]])


# -- the examples' asserted outcomes, run against the port ------------------

def test_example_qaoa_maxcut():
    """examples/qaoa_maxcut.py: 60 descent steps on (gamma, beta) lift the
    expected cut of the 6-ring above 0.75 of its edges, and the sampled
    cuts reach the optimum. The port takes central differences where the
    example takes jax.grad."""
    n, p = 6, 2
    edges = [(q, (q + 1) % n) for q in range(n)]
    fn = interpreter.compile_ir(circuits.qaoa_maxcut_ir(n, p, edges))

    def state(params):
        return fn(sv.init_state(n, device="cpu"), params)

    def cut(params):
        st = state(params)
        return sum(0.5 * (1.0 - float(sv.expval_pauli_product_z(st, [a, b])))
                   for a, b in edges)

    params = np.asarray([0.4, 0.7] * p, np.float64)
    h = 1e-3
    for _ in range(60):
        grad = np.array([(cut(params + h * e) - cut(params - h * e)) / (2 * h)
                         for e in np.eye(len(params))])
        params = params + 0.08 * grad
    best_cut = cut(params)
    assert best_cut > 0.75 * len(edges), best_cut
    probs = np.abs(state(params).numpy()) ** 2
    samples = np.random.default_rng(0).choice(1 << n, size=400,
                                              p=probs / probs.sum())
    best = max(sum(1 for a, b in edges if ((int(s) >> a) & 1)
                   != ((int(s) >> b) & 1)) for s in samples)
    assert best == len(edges)


def test_example_phase_estimation_grover():
    m, phase = 6, 13 / 64
    ir = circuits.qpe_ir(m, phase)
    st = interpreter.execute(sv.init_state(m + 1, device="cpu"), ir.ops)
    probs = sv.marginal_probs(st, range(m)).numpy()
    assert int(probs.argmax()) == round(phase * (1 << m))
    assert probs.max() > 0.99
    n, marked = 7, 42
    gir = circuits.grover_ir(n, marked)
    pg = np.abs(interpreter.execute(sv.init_state(n, device="cpu"),
                                    gir.ops).numpy()) ** 2
    assert int(pg.argmax()) == marked and pg[marked] > 0.95


def test_example_run_bell_state():
    bell = QuantumCircuit(num_qubits=2)
    bell.h(0)
    bell.cx(0, 1)
    text = bell.to_qasm()
    set_target("local", device="cpu")
    backend = get_active_backend()
    job = backend.submit_job(text, shots=200)
    assert backend.get_job_status(job) == "completed"
    assert set(backend.get_job_result(job)) <= {"00", "11"}
    set_target("qristal", device="cpu")
    backend = get_active_backend()
    result = backend.get_job_result(backend.submit_job(bell, shots=100))
    assert set(result) <= {"00", "11"} and sum(result.values()) == 100


def test_example_compiler_qir():
    """examples/compiler_qir_example.py without its StableHLO line."""
    @dsl.kernel
    def bell():
        q = dsl.qvec(2)
        dsl.h(q[0])
        dsl.cnot(q[0], q[1])

    assert "gate_name" in bell.mlir()
    qir = bell.qir()
    assert "__quantum__qis__h__body" in qir
    assert "__quantum__qis__cnot__body" in qir
    assert "call void @__quantum__qis__h__body" in qir
    comp = Compiler()
    assert comp.load_module_from_string(
        "OPENQASM 3.0;\nqubit[2] q;\nbit[2] c;\n"
        "h q[0];\ncx q[0], q[1];\nc = measure q;")
    assert comp.run_adjoint_generation_pass()
    assert [op.name for op in comp.adjoint_module.ops] == ["CNOT", "H"]
    assert "gate_name" in comp.adjoint_module.dump()


def test_example_vqe_h2_noisy():
    h2_terms = [("Z0", 0.3435), ("Z1", -0.4347), ("Z0 Z1", 0.5716),
                ("X0 X1", 0.0910), ("Y0 Y1", 0.0910)]
    offset = -0.4804 + 0.7137
    noiseless_ground = -1.1375

    @dsl.kernel
    def ansatz(t0, t1, t2, t3):
        q = dsl.qvec(2)
        dsl.ry(t0, q[0])
        dsl.ry(t1, q[1])
        dsl.cnot(q[0], q[1])
        dsl.ry(t2, q[0])
        dsl.ry(t3, q[1])

    noise = dsl.NoiseModel()
    noise.add_channel("depolarizing", 0.01)

    def energy(params):
        bindings = dict(zip(["t0", "t1", "t2", "t3"], params))
        return offset + sum(coeff * dsl.get_expectation_value(
            ansatz, dsl.PauliOperator(s), backend="density_matrix",
            noise_model=noise, device="cpu", **bindings)
            for s, coeff in h2_terms)

    result = minimize(energy, x0=np.full(4, 0.1), method="COBYLA",
                      options={"maxiter": 150})
    assert result.fun >= noiseless_ground - 1e-6
    assert result.fun < -1.0
