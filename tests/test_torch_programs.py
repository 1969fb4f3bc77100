"""The port's program front ends against the JAX package's: the OpenQASM 3
parser, QIR emission, ``Compiler``, ``QuantumSimulator``,
``QuantumCircuit``, ``core``, the CLI and the backends.

Parsers and printers must give identical IR, programs and text. Engines
are compared on the same circuits: complex64 within 1e-5 of max|amp| (the
JAX side in Pallas interpret mode at N = 15), probabilities within 1e-5,
and histograms statistically (each outcome's fraction within 0.03 of its
probability). Cloud clients are compared by their payloads and by the
requests they send, with ``requests`` mocked as in tests/test_qpu_layer.py.
"""

import ast
import dataclasses
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rocquantum_tpu.cli as jax_cli
import rocquantum_tpu.core as jax_core
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.compiler import qasm_parser as jax_parser
from rocquantum_tpu.compiler.pipeline import Compiler as JaxCompiler
from rocquantum_tpu.compiler.qasm import to_qasm3 as jax_to_qasm3
from rocquantum_tpu.compiler.qir import emit_qir_text as jax_emit_qir
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.ops import statevec as jsv
from rocquantum_tpu.qcircuit import QuantumCircuit as JaxQuantumCircuit
from rocquantum_tpu.simulator import QuantumSimulator as JaxSimulator
import rocquantum_tpu_torch.cli as port_cli
import rocquantum_tpu_torch.core as port_core
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.backends import JobSubmissionError
from rocquantum_tpu_torch.compiler import Compiler, MLIRCompiler
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.compiler import qasm_parser
from rocquantum_tpu_torch.compiler.qasm import to_qasm3
from rocquantum_tpu_torch.compiler.qir import emit_qir_text
from rocquantum_tpu_torch.ops import fused_sv
from rocquantum_tpu_torch.ops import statevec as sv
from rocquantum_tpu_torch.qcircuit import QuantumCircuit
from rocquantum_tpu_torch.simulator import QSim, QuantumSimulator

HERE = os.path.dirname(__file__)
N = 15
F32_TOL = 1e-5
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
    jax_core._ACTIVE_BACKEND = None
    port_core._ACTIVE_BACKEND = None
    jax_interp.clear_cache()
    interpreter.clear_cache()


def _norm(obj):
    """A package-neutral form of IR objects: dataclasses by class name and
    fields, arrays by value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _norm(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_norm(x) for x in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _norm(v)) for k, v in obj.items()))
    if isinstance(obj, np.ndarray):
        return ("array", obj.shape, tuple(np.ravel(obj).tolist()))
    return obj


def _ir_form(ir):
    return (ir.num_qubits, ir.name, _norm(list(ir.ops)))


def _qasm_texts():
    """Every OpenQASM text of tests/test_qasm_dynamic.py: its string
    constants and its module-level texts."""
    path = os.path.join(HERE, "test_qasm_dynamic.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    texts = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and isinstance(node.value, str)
             and ("qubit[" in node.value or "qreg " in node.value)]
    spec = importlib.util.spec_from_file_location("_qasm_dynamic", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    texts += [v for k, v in vars(module).items()
              if k.endswith("_QASM") and isinstance(v, str)]
    return texts


QASM_TEXTS = _qasm_texts()


def _parse_both(parse_jax, parse_port, text):
    try:
        ref = parse_jax(text)
    except Exception as e:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(type(e)):
            parse_port(text)
        return None
    return ref, parse_port(text)


@pytest.mark.parametrize("index", range(len(QASM_TEXTS)))
def test_parser_gives_the_same_program(index):
    text = QASM_TEXTS[index]
    pair = _parse_both(jax_parser.parse_qasm3_program,
                       qasm_parser.parse_qasm3_program, text)
    if pair is None:
        return
    ref, got = pair
    assert _norm(got) == _norm(ref)
    assert got.is_static == ref.is_static
    pair = _parse_both(jax_parser.parse_qasm3, qasm_parser.parse_qasm3, text)
    if pair is not None:
        assert _ir_form(pair[1]) == _ir_form(pair[0])


def test_the_texts_include_static_and_dynamic_programs():
    static = [t for t in QASM_TEXTS
              if _parse_both(jax_parser.parse_qasm3, qasm_parser.parse_qasm3,
                             t) is not None]
    assert len(static) >= 10 and len(QASM_TEXTS) - len(static) >= 10


def _zoo():
    return [jax_circuits.qft_ir(6), jax_circuits.ghz_ir(5),
            jax_circuits.hardware_efficient_ansatz_ir(4, 2),
            jax_circuits.random_circuit_ir(5, 3, 1),
            jax_circuits.qpe_ir(3, 0.25), jax_circuits.grover_ir(3, 5)]


@pytest.mark.parametrize("index", range(6))
def test_qasm_round_trip_of_the_zoo(index):
    ir = _zoo()[index]
    if ir.num_params:
        return  # OpenQASM carries concrete angles only
    text = jax_to_qasm3(ir)
    assert _ir_form(qasm_parser.parse_qasm3(text)) == \
        _ir_form(jax_parser.parse_qasm3(text))


@pytest.mark.parametrize("index", range(6))
def test_port_qasm_keeps_controls(index):
    """The port's emitter writes a controlled P (the QFT's, the phase
    estimation's) with ``ctrl @``, so both parsers read back the circuit's
    own ops; the JAX package's emitter prints the control as a second
    target (``p(x) q[c], q[t];``), which parses as another gate."""
    ir = convert.ir_from_reference(_zoo()[index])
    if ir.num_params:
        return
    text = to_qasm3(ir)
    want = [(op.name, op.targets, op.controls) for op in ir.ops]
    for parse in (qasm_parser.parse_qasm3, jax_parser.parse_qasm3):
        back = parse(text)
        assert [(op.name, op.targets, op.controls) for op in back.ops] == \
            want
        assert np.allclose([p for op in back.ops for p in op.params],
                           [p for op in ir.ops for p in op.params],
                           rtol=1e-11, atol=1e-11)
    named = {"CNOT", "CX", "CZ", "CRX", "CRY", "CRZ", "MCX", "CCX",
             "TOFFOLI", "CSWAP"}
    if not any(op.controls and op.name not in named for op in ir.ops):
        assert text == jax_to_qasm3(_zoo()[index])


@pytest.mark.parametrize("index", range(6))
def test_qir_text_is_identical(index):
    ir = _zoo()[index]
    assert emit_qir_text(convert.ir_from_reference(ir)) == jax_emit_qir(ir)


def test_qir_of_adjoint_and_controlled_ops():
    from rocquantum_tpu.compiler.passes import adjoint_ir as jax_adjoint
    ir = jax_circuits.qft_ir(4)
    ir.add("MCX", [3], controls=[0, 1, 2])
    ir.add("CSWAP", [1, 2], controls=[0])
    ir.add("U3", [0], params=[0.1, 0.2, 0.3])
    for ref in (ir, jax_adjoint(ir)):
        assert emit_qir_text(convert.ir_from_reference(ref)) == \
            jax_emit_qir(ref)


BELL = ("OPENQASM 3.0;\nqubit[2] q;\nbit[2] c;\n"
        "h q[0];\ncx q[0], q[1];\nc = measure q;")


def test_compiler_load_passes_and_qir():
    jc, pc = JaxCompiler(), Compiler()
    assert MLIRCompiler is Compiler
    text = jax_to_qasm3(jax_circuits.qft_ir(5))
    assert pc.load_module_from_string(text) and jc.load_module_from_string(
        text)
    assert pc.get_module_string() == jc.get_module_string()
    assert _norm(pc.run_fusion_pass()) == _norm(jc.run_fusion_pass())
    assert _norm(pc.run_fusion_pass(3)) == _norm(jc.run_fusion_pass(3))
    assert pc.run_adjoint_generation_pass()
    assert jc.run_adjoint_generation_pass()
    assert _ir_form(pc.adjoint_module) == _ir_form(jc.adjoint_module)
    assert pc.emit_qir() == jc.emit_qir()
    assert pc.emit_qir(BELL) == jc.emit_qir(BELL)
    assert not pc.load_module_from_string("qubit[1] q;\nfrobnicate q[0];")
    assert not Compiler().run_adjoint_generation_pass()
    with pytest.raises(RuntimeError):
        Compiler().compile()
    with pytest.raises(NotImplementedError):
        pc.emit_stablehlo()
    pc.initialize_module("m", 3)
    assert pc.module.num_qubits == 3 and pc.module.name == "m"


@pytest.mark.parametrize("n", [5, N])
def test_compiler_compile_runs_the_flat_engine(n):
    """The QFT's OpenQASM through load, compile and a run on a basis state:
    the closed form, and at n = 5 the JAX package's Compiler (its N = 15
    QFT is held to the JAX package in tests/test_torch_execute.py)."""
    text = to_qasm3(convert.ir_from_reference(jax_circuits.qft_ir(n)))
    pc = Compiler()
    assert pc.load_module_from_string(text)
    x = 11
    got = pc.compile()(sv.basis_state(n, x, device="cpu"), None).numpy()
    if n < N:
        jc = JaxCompiler()
        jc.load_module_from_string(text)
        ref = np.asarray(jc.compile()(jsv.basis_state(n, x), jnp.zeros(0)))
        assert np.max(np.abs(got - ref)) <= F32_TOL * np.max(np.abs(ref))
    k = np.arange(1 << n)
    closed = np.exp(2j * np.pi * ((x * k) % (1 << n)) / (1 << n)) \
        / np.sqrt(1 << n)
    assert np.max(np.abs(got - closed)) <= 2e-6


def _drive(sim, matrix):
    sim.apply_gate("H", [0])
    sim.apply_gate("CNOT", [0, 2])
    sim.apply_gate("RY", [1], [0.4])
    sim.apply_gate("CRZ", [1, 3], [0.7])
    sim.apply_gate("CCX", [0, 1, 3])
    sim.apply_gate("CSWAP", [2, 0, 3])
    sim.apply_gate("sdg", [2])
    sim.apply_matrix(matrix, [3, 1])
    sim.apply_gate("cx", [3, 0])


def test_quantum_simulator_modern_api():
    u, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(4, 4)))
    ref, got = JaxSimulator(4, seed=1), QuantumSimulator(4, seed=1,
                                                         device="cpu")
    for sim in (ref, got):
        _drive(sim, u)
    psi = got.get_statevector()
    assert psi.dtype == np.complex128
    assert np.max(np.abs(psi - ref.get_statevector())) <= F32_TOL
    for qubits in (None, [2], [3, 0], [1, 2, 3]):
        np.testing.assert_allclose(got.get_probabilities(qubits),
                                   ref.get_probabilities(qubits),
                                   atol=F32_TOL)
    draws = got.measure([0, 1], 20000)
    assert isinstance(draws, list) and all(isinstance(d, int) for d in draws)
    marg = got.get_probabilities([0, 1])
    freq = np.bincount(draws, minlength=4) / 20000
    assert np.max(np.abs(freq - marg)) <= FREQ_TOL
    counts = got.sample_counts(20000, [3])
    assert abs(counts.get(1, 0) / 20000 - ref.get_probabilities([3])[1]) \
        <= FREQ_TOL
    with pytest.raises(ValueError):
        got.apply_gate("FOO", [0])
    with pytest.raises(ValueError):
        got.apply_matrix(np.eye(2), [0, 1])
    with pytest.raises(ValueError):
        QuantumSimulator(0, device="cpu")
    got.reset()
    ref.reset()
    assert np.max(np.abs(got.get_statevector()
                         - ref.get_statevector())) == 0.0


def test_quantum_simulator_legacy_api():
    ref, got = JaxSimulator(3), QSim(3, device="cpu")
    for sim in (ref, got):
        sim.ApplyGate("H", 0)
        sim.ApplyCNOT(0, 1)
        sim.ApplyGate("X", 2)
        sim.Execute()
    assert np.max(np.abs(got.GetStateVector() - ref.GetStateVector())) \
        <= F32_TOL


def test_quantum_simulator_at_kernel_width(monkeypatch):
    calls = []
    wrapped = fused_sv.apply_fused_layer
    monkeypatch.setattr(fused_sv, "apply_fused_layer",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    theta = np.random.default_rng(2).normal(size=N)
    ref, got = JaxSimulator(N), QuantumSimulator(N, device="cpu")
    for sim in (ref, got):
        for q in range(N):
            sim.apply_gate("RY", [q], [theta[q]])
        for q in range(N):
            sim.apply_gate("CNOT", [q, (q + 1) % N])
    psi = got.get_statevector()
    assert calls, "no kernel pass ran"
    ref_psi = ref.get_statevector()
    assert np.max(np.abs(psi - ref_psi)) <= F32_TOL * np.max(np.abs(ref_psi))
    np.testing.assert_allclose(got.get_probabilities([0, 7, 14]),
                               ref.get_probabilities([0, 7, 14]),
                               atol=F32_TOL)


def _bell_circuits():
    out = []
    for cls in (JaxQuantumCircuit, QuantumCircuit):
        c = cls(4)
        c.h(0)
        c.x(1)
        c.y(2)
        c.z(3)
        c.s(0)
        c.t(1)
        c.rx(0.5, 2)
        c.ry(-0.25, 3)
        c.rz(1.5, 0)
        c.cx(0, 1)
        c.cz(2, 3)
        c.swap(1, 2)
        out.append(c)
    return out


def test_quantum_circuit_qasm_and_ir():
    ref, got = _bell_circuits()
    assert _ir_form(got.to_ir()) == _ir_form(ref.to_ir())
    assert got.to_qasm() == ref.to_qasm()
    with pytest.raises(ValueError):
        got.measure_all()
    with pytest.raises(ValueError):
        QuantumCircuit(0)
    with pytest.raises(ValueError):
        QuantumCircuit(2).cx(1, 1)


def test_core_registry():
    assert port_core.available_backends() == jax_core.available_backends()
    with pytest.raises(RuntimeError):
        port_core.get_active_backend()
    with pytest.raises(ValueError):
        port_core.set_target("nowhere")
    port_core.set_target("local", device="cpu")
    backend = port_core.get_active_backend()
    assert type(backend).__module__ == "rocquantum_tpu_torch.backends.local"
    for name in port_core._AVAILABLE_BACKENDS.values():
        assert name.startswith("rocquantum_tpu_torch.backends.")


def test_cli_list_and_local_run(capsys):
    assert port_cli.main(["list"]) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(["list"]) == 0
    assert port_out == capsys.readouterr().out
    assert port_cli.main(["run", "--backend", "local", "--device", "cpu",
                          "--shots", "200", "--poll-interval", "0"]) == 0
    out = capsys.readouterr().out
    assert "Job status: completed" in out
    results = ast.literal_eval(out.split("--> Results: ")[1].splitlines()[0])
    assert set(results) <= {"00", "11"} and sum(results.values()) == 200


def test_cli_credential_preflight(monkeypatch, capsys):
    monkeypatch.delenv("IONQ_API_KEY", raising=False)
    assert port_cli.main(["run", "--backend", "ionq"]) == 1
    assert "IONQ_API_KEY" in capsys.readouterr().out


GHZ_TEXT = jax_to_qasm3(jax_circuits.ghz_ir(4), add_measure_all=True)


def _histogram(module, circuit, shots, **kwargs):
    module.set_target("local", **kwargs)
    backend = module.get_active_backend()
    job = backend.submit_job(circuit, shots)
    assert backend.get_job_status(job) == "completed"
    return backend.get_job_result(job)


def test_local_backend_static_histograms():
    shots = 4000
    got = _histogram(port_core, GHZ_TEXT, shots, device="cpu")
    ref = _histogram(jax_core, GHZ_TEXT, shots)
    for hist in (got, ref):
        assert set(hist) <= {"0000", "1111"} and sum(hist.values()) == shots
        assert abs(hist.get("1111", 0) / shots - 0.5) <= FREQ_TOL
    circ = QuantumCircuit(3)
    circ.h(0)
    circ.ry(1.0, 1)
    circ.cx(0, 2)
    got = _histogram(port_core, circ, shots, device="cpu")
    probs = QuantumSimulator(3, device="cpu")
    for op in circ.to_ir().ops:
        probs._queue.append(op)
    p = probs.get_probabilities()
    for k in range(8):
        frac = got.get(format(k, "03b"), 0) / shots
        assert abs(frac - p[k]) <= FREQ_TOL
    with pytest.raises(JobSubmissionError):
        _histogram(port_core, 42, 10, device="cpu")


def test_local_backend_dynamic_branch_raises():
    """The dynamic branch no longer raises: a dynamic program runs
    shot-batched (tests/test_torch_dynamic.py holds it against the JAX
    package in full); here the whole histogram is counted."""
    text = [t for t in QASM_TEXTS if "if" in t and "measure" in t][0]
    assert not jax_parser.parse_qasm3_program(text).is_static
    port_core.set_target("local", device="cpu")
    backend = port_core.get_active_backend()
    hist = backend.get_job_result(backend.submit_job(text, 100))
    n = jax_parser.parse_qasm3_program(text).num_qubits
    assert sum(hist.values()) == 100 and all(len(k) == n for k in hist)


def test_qristal_runs_on_the_local_simulator():
    circ = QuantumCircuit(2)
    circ.h(0)
    circ.cx(0, 1)
    port_core.set_target("qristal", device="cpu")
    backend = port_core.get_active_backend()
    hist = backend.get_job_result(backend.submit_job(circ, 300))
    assert set(hist) <= {"00", "11"} and sum(hist.values()) == 300


CLOUD = ["ionq", "infleqtion", "pasqal", "quantinuum", "rigetti", "iqm",
         "xanadu", "quera", "orca", "seeqc", "quantum_machines", "alice_bob"]


def _classes(name):
    out = []
    for core in (jax_core, port_core):
        module, cls = core._AVAILABLE_BACKENDS[name].rsplit(".", 1)
        out.append(getattr(importlib.import_module(module), cls))
    return out


@pytest.mark.parametrize("name", CLOUD)
def test_cloud_client_payloads_match(name):
    ref_cls, port_cls = _classes(name)
    ref, got = ref_cls(), port_cls()
    assert (got.backend_name, got.api_endpoint) == \
        (ref.backend_name, ref.api_endpoint)
    for shots in (1, 1000):
        assert got._build_payload(BELL, shots) == \
            ref._build_payload(BELL, shots)
    for attr in ("API_KEY_ENV", "DEFAULT_ENDPOINT", "DEFAULT_BACKEND_NAME",
                 "AUTH_SCHEME"):
        assert getattr(got, attr, None) == getattr(ref, attr, None)


REST = ["ionq", "infleqtion", "pasqal", "iqm", "xanadu", "quera", "orca",
        "seeqc", "quantum_machines", "alice_bob"]


def _response(payload):
    resp = mock.Mock()
    resp.status_code = 200
    resp.json.return_value = payload
    resp.raise_for_status.return_value = None
    return resp


@pytest.mark.parametrize("name", REST)
def test_cloud_client_requests_match(name, monkeypatch):
    for var in ("IONQ_API_KEY", "SUPERSTAQ_API_KEY", "PASQAL_API_KEY"):
        monkeypatch.setenv(var, "test-key")
    calls = []
    for cls in _classes(name):
        backend = cls()
        env = getattr(backend, "API_KEY_ENV", None)
        if env:
            monkeypatch.setenv(env, "test-key")
        backend.authenticate()
        with mock.patch("requests.post",
                        return_value=_response({"id": "job-1"})) as post:
            assert backend.submit_job(BELL, shots=64) == "job-1"
        with mock.patch("requests.get", return_value=_response(
                {"status": "completed",
                 "data": {"histogram": {"00": 32, "11": 32}}})) as get:
            status = backend.get_job_status("job-1")
            result = backend.get_job_result("job-1")
        calls.append((post.call_args, get.call_args_list, status, result))
    assert calls[0] == calls[1]
