"""The PyTorch port stands without JAX: it imports, and runs a circuit,
in a process where importing jax (or the JAX package) fails."""

import ast
import os
import subprocess
import sys

import rocquantum_tpu_torch

PKG_DIR = os.path.dirname(rocquantum_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_BLOCK_JAX = r"""
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "rocquantum_tpu"):
        del sys.modules[name]
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["rocquantum_tpu"] = None
"""

_BELL = _BLOCK_JAX + r"""
import numpy as np
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch.ops import fused_sv

c = rq.Circuit(3, rq.Simulator(seed=5, device="cpu"))
c.h(0)
c.cx(0, 1)
psi = c.get_statevector()
want = np.zeros(8)
want[0] = want[3] = 2 ** -0.5
assert np.allclose(psi, want, atol=1e-6), psi
counts = c.sample_counts([0, 1], 400)
assert set(counts) <= {"00", "11"}, counts
assert abs(c.expval(rq.PauliOperator("Z0 Z1")) - 1.0) < 1e-6
assert fused_sv.LAUNCHES == 0
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# a double-float circuit at the kernel-routing width: kernel blocks go
# through the df64 layer (its plain version on the CPU), the state stays
# (re, None) and normalized
_DF64 = _BLOCK_JAX + r"""
import numpy as np
import rocquantum_tpu_torch as rq
rq.set_precision("df64")
c = rq.Circuit(15, rq.Simulator(device="cpu"))
for q in range(15):
    c.ry(0.2 + 0.1 * q, q)
c.cx(0, 14)
c.flush()
assert c.state[1] is None
assert abs(np.linalg.norm(c.get_statevector()) - 1.0) < 1e-13
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# the relabel layer and the region dots, through their plain versions
_RELABEL_AND_DOTS = _BLOCK_JAX + r"""
import numpy as np
import torch
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.compiler.ir import GateOp
from rocquantum_tpu_torch.ops import region_dot, relabel, rotate, statevec

n = 12
gm = np.zeros((2, 2, 2, 2), np.float32)
gm[:, 0, 0, 0] = gm[:, 1, 1, 0] = 1.0  # identities
plan = [relabel.Rotation(2),
        relabel.KernelPass(gate_idx=(0, 1), positions=((0,), (9,))),
        relabel.Rotation(3)]
re, im = relabel.execute_plan(None, None, plan, gm, n, ["U", "U"],
                              real_flags=[True, True], device="cpu")
assert im is None and float(re[0]) == 1.0 and float(re.abs().sum()) == 1.0
x = torch.arange(1 << n, dtype=torch.float32)
y = relabel.rotate_region(x, n, 3)
assert torch.equal(relabel.rotate_region(y, n, 2), x)
psi = torch.randn(1 << 6, dtype=torch.complex64)
op = GateOp("PERMUTE_BITS", (1, 4), (4, 1))
assert torch.equal(interpreter.apply_op(psi, op),
                   statevec.swap_index_bits(psi, 1, 4))
x = torch.randn(32, 4096)
m = torch.eye(128)
assert torch.equal(region_dot.lane_dot(x.clone(), m), x)
assert torch.equal(region_dot.row_dot(torch.eye(32), x.clone()), x)
assert rotate.LAUNCHES == region_dot.LANE_LAUNCHES == 0
assert region_dot.ROW_LAUNCHES == 0
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# the front end, the adjoint gradient and compile_program at the
# kernel-routing width (the fused layer's plain version on the CPU)
_GRADIENT = _BLOCK_JAX + r"""
import numpy as np
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch.solvers import VQE_Solver

@rq.kernel
def ring(q, *theta):
    for k, t in enumerate(theta):
        q.ry(t, k)
    for k in range(15):
        q.cx(k, (k + 1) % 15)

h = rq.PauliOperator({"Z0 Z1": -1.0, "X3": -0.5, "Y4 Y5": 0.25})
sim = rq.Simulator(device="cpu")
theta = np.linspace(-1.0, 1.0, 15)
value, grads = rq.adjoint_grad(ring, 15, sim, theta, h, return_value=True)
prog = rq.compile_program(rq.trace_kernel(ring, 15, *theta), sim,
                          observable=h)
assert abs(prog.run() - value) < 1e-5, (prog.run(), value)
shift = np.zeros(15)
shift[3] = np.pi / 2
ps = 0.5 * (prog.run(theta + shift) - prog.run(theta - shift))
assert abs(grads[3] - ps) < 1e-4, (grads[3], ps)
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# the density engine at the kernel-routing width (2n = 16 bits): a noisy
# flush through the fused layer's plain version, the readouts, a measure,
# the exact engine and DensityMatrixState
_DENSITY = _BLOCK_JAX + r"""
import numpy as np
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch.ops import fused_sv

noise = rq.NoiseModel()
noise.add_channel("bit_flip", 0.01, after_op="cnot")
c = rq.DensityCircuit(8, rq.Simulator(seed=3, device="cpu"),
                      noise_model=noise)
for q in range(8):
    c.ry(0.3 + 0.01 * q, q)
c.apply_channel("depolarizing", 0.02, list(range(8)))
c.flush()
assert c.state[1] is None
want = np.cos(0.3) * (1 - 0.08 / 3)
assert abs(c.expval(rq.PauliOperator("Z0")) - want) < 1e-5
c.cx(0, 1)
c.rz(0.4, 2)
c.apply_channel("amplitude_damping", 0.05, [3])
rho = c.get_density_matrix()
assert abs(np.trace(rho) - 1) < 1e-5 and np.allclose(rho, rho.conj().T,
                                                     atol=1e-6)
assert 0 < c.purity() < 1
outcome, p = c.measure(2)
assert 0 < p <= 1 and c.sample([0, 1], 50).dtype == np.int32
rq.set_precision("double")
st = rq.DensityMatrixState(2, device="cpu")
st.apply_h(0)
st.apply_cnot(0, 1)
st.apply_depolarizing_channel([0, 1], 0.05)
assert abs(st._compute_z_product_expectation([0, 1])
           - (1 - 0.2 / 3) ** 2) < 1e-12
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# a sliced tensor-network contraction (native greedy plan), an SVD, and the
# df64 readout twins and compile_df64_ir
_TENSORNET_AND_DF64_READOUT = _BLOCK_JAX + r"""
import numpy as np
import torch
from rocquantum_tpu_torch.compiler.ir import CircuitIR
from rocquantum_tpu_torch.ops import df64
from rocquantum_tpu_torch.tensornet import TensorNetwork, tensor_svd

rng = np.random.default_rng(0)
a = rng.normal(size=(32, 16)).astype(np.complex64)
b = rng.normal(size=(16, 32)).astype(np.complex64)
tn = TensorNetwork(device="cpu")
tn.add_tensor(a, ["a", "k"])
tn.add_tensor(b, ["k", "b"])
out = tn.contract({"memory_limit": 32 * 32 * 8 // 8})
assert tn.last_num_slices == 32  # a in 8 chunks, b in 4
assert np.allclose(out.to_numpy(), a @ b, atol=1e-4)
u, s, v = tensor_svd(out, ["a"])
assert s.shape == (32,) and float(s.data[16]) < 1e-3 * float(s.data[0])
ir = CircuitIR(4)
ir.add("H", [0])
ir.add("CNOT", [1], controls=[0])
planes = df64.compile_df64_ir(ir)(*df64.init_df64(4, "cpu"))
energy = df64.expval_terms_df64(planes, [(("Z", 0), ("Z", 1)), (("X", 0),)],
                                [1.0, 0.5])
assert abs(float(energy) - 1.0) < 1e-12, float(energy)
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# the program front ends: OpenQASM text through core.set_target("local"),
# the CLI as ``python -m``, a dsl kernel on both backends, QuantumSimulator
_FRONT_ENDS = _BLOCK_JAX + r"""
import runpy
import numpy as np
from rocquantum_tpu_torch import core, dsl
from rocquantum_tpu_torch.compiler import Compiler
from rocquantum_tpu_torch.simulator import QuantumSimulator

core.set_target("local", device="cpu")
backend = core.get_active_backend()
text = "OPENQASM 3.0;\nqubit[3] q;\nbit[3] c;\nh q[0];\ncx q[0], q[1];\n" \
    "ctrl @ x q[1], q[2];\nc = measure q;"
hist = backend.get_job_result(backend.submit_job(text, 500))
assert set(hist) <= {"000", "111"} and sum(hist.values()) == 500, hist
comp = Compiler()
assert comp.load_module_from_string(text)
assert "__quantum__qis__h__body" in comp.emit_qir()

@dsl.kernel
def bell(theta):
    q = dsl.qvec(2)
    dsl.ry(theta, q[0])
    dsl.cnot(q[0], q[1])

psi = dsl.execute(bell, device="cpu", theta=np.pi / 2)
assert np.allclose(np.abs(psi) ** 2, [0.5, 0, 0, 0.5], atol=1e-6), psi
zz = dsl.get_expectation_value(bell, dsl.PauliOperator("Z0 Z1"),
                               "density_matrix", device="cpu", theta=0.3)
assert abs(zz - 1.0) < 1e-6, zz

sim = QuantumSimulator(3, device="cpu")
sim.apply_gate("H", [0])
sim.apply_gate("CNOT", [0, 2])
assert np.allclose(sim.get_probabilities([0, 2]), [0.5, 0, 0, 0.5],
                   atol=1e-6)

sys.argv = ["rocq", "run", "--backend", "local", "--device", "cpu",
            "--shots", "50", "--poll-interval", "0"]
try:
    runpy.run_module("rocquantum_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# batched and dynamic circuits, QEC, checkpoints and phase timers
_BATCHED_AND_DYNAMIC = _BLOCK_JAX + r"""
import os
import tempfile
import numpy as np
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import qec
from rocquantum_tpu_torch.backends.local import LocalBackend
from rocquantum_tpu_torch.compiler import dynamic
from rocquantum_tpu_torch.compiler.qasm_parser import parse_qasm3_program
from rocquantum_tpu_torch.qec.codes import steane_code
from rocquantum_tpu_torch.qec.decoders import steane_decoder
from rocquantum_tpu_torch.utils import checkpoint, profiling

c = rq.Circuit(3, rq.Simulator(seed=5, device="cpu"), batch_size=3)
c.h(0)
outcomes, probs = c.measure(0)
c.cx(0, 1)
psi = c.get_statevector()
assert psi.shape == (3, 8) and np.allclose(probs, 0.5, atol=1e-6)
for b in range(3):
    assert abs(abs(psi[b, 3 * int(outcomes[b])]) - 1) < 1e-6
assert c.expval(rq.PauliOperator("Z0 Z1")).shape == (3,)
path = os.path.join(tempfile.mkdtemp(), "ckpt.npz")
checkpoint.save_circuit_checkpoint(path, c)
c2 = rq.Circuit(3, rq.Simulator(device="cpu"), batch_size=3)
checkpoint.restore_circuit_checkpoint(path, c2)
assert np.array_equal(c2.get_statevector(), psi)

text = "OPENQASM 3.0;\nqubit[2] q;\nbit[1] c;\nh q[0];\n" \
    "c[0] = measure q[0];\nif (c[0] == 1) { x q[1]; }"
hist = dynamic.run_dynamic(parse_qasm3_program(text), 64, seed=3,
                           device="cpu")
assert set(hist) <= {"00", "11"} and sum(hist.values()) == 64, hist
backend = LocalBackend(device="cpu")
assert backend.get_job_result(backend.submit_job(text, 10)) != {}

def logical_zero_with_y3(q):
    for piv, rest in ((0, (2, 4, 6)), (1, (2, 5, 6)), (3, (4, 5, 6))):
        q.h(piv)
        for d in rest:
            q.cx(piv, d)
    q.y(3)

timer = profiling.PhaseTimer(device="cpu")
with timer.phase("qec"):
    result = qec.QEC_Experiment(rq.Simulator(device="cpu")).run_single_round(
        steane_code.SteaneCode(), steane_decoder.SteaneDecoder(),
        rq.kernel(logical_zero_with_y3), 13, list(range(7, 13)))
assert result["syndrome"] == [0, 0, 1, 0, 0, 1], result
assert "Y3" in result["correction_applied"]
assert timer.summary()["qec"]["count"] == 1
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# the sharded engine on 8 virtual CPU shards (a scheduled flush with
# exchanges, readouts, a measure, the merged restore), a sharded density
# flush, a mesh-spread contraction and the compat shims
_SHARDED = _BLOCK_JAX + r"""
import numpy as np
import torch
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch.compat import _rocq_hip_backend, rocq, rocquantum
from rocquantum_tpu_torch.parallel import count_collectives, make_mesh
from rocquantum_tpu_torch.tensornet import TensorNetwork

mesh = make_mesh(8, devices=[torch.device("cpu")] * 8)
c = rq.Circuit(6, rq.Simulator(seed=1, device="cpu"), mesh=mesh)
c.h(5)
for t in range(5):
    c.cx(5, t)
assert abs(c.expval(rq.PauliOperator("Z0 Z5")) - 1.0) < 1e-6
m, p = c.measure(5)
assert abs(p - 0.5) < 1e-6
psi = c.get_statevector()
assert abs(abs(psi[63 if m else 0]) - 1.0) < 1e-6
assert count_collectives()["all-to-all"] >= 1
d = rq.DensityCircuit(4, rq.Simulator(device="cpu"), mesh=mesh)
d.h(3)
d.apply_channel("depolarizing", 0.1, [3])
assert abs(d.purity() - np.trace(np.linalg.matrix_power(
    d.get_density_matrix(), 2)).real) < 1e-6
tn = TensorNetwork(device="cpu")
tn.add_tensor(np.eye(8, dtype=np.complex64), ["a", "b"])
tn.add_tensor(np.eye(8, dtype=np.complex64), ["b", "a"])
assert abs(complex(tn.contract(mesh=mesh, axis_name="sv").data) - 8) < 1e-5
h = _rocq_hip_backend.RocsvHandle(device="cpu")
buf = _rocq_hip_backend.allocate_state_internal(h, 2)
_rocq_hip_backend.apply_h(h, buf, 2, 0)
assert abs(_rocq_hip_backend.get_expectation_value_x(h, buf, 2, 0) - 1) < 1e-6
assert rocq.Simulator is rq.Simulator and callable(rocquantum.get_expval)
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


# the Qiskit, Cirq and PennyLane plugins on the in-repo framework stubs,
# the flat complex-rho API and the float64 pair surface
_INTEGRATIONS_AND_SURFACE = _BLOCK_JAX + r"""
import os
sys.path.append(os.path.join(os.getcwd(), "tests", "_stubs"))
import numpy as np
import torch
import cirq
import pennylane as qml
from qiskit import QuantumCircuit
from rocquantum_tpu_torch import config, convert
from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp
from rocquantum_tpu_torch.integrations import (cirq_simulator,
                                               pennylane_device,
                                               qiskit_provider)
from rocquantum_tpu_torch.ops import density, gates, pairdm, pairsim

qc = QuantumCircuit(2, 2)
qc.h(0)
qc.cx(0, 1)
qc.measure([0, 1], [0, 1])
backend = qiskit_provider.RocQuantumProvider(device="cpu").get_backend()
assert set(backend.run(qc, shots=100).get_counts()) <= {"00", "11"}
q0, q1 = cirq.LineQubit.range(2)
(res,) = cirq_simulator.RocQuantumSimulator(device="cpu").simulate_sweep(
    cirq.Circuit([cirq.H(q0), cirq.CNOT(q0, q1)]))
assert abs(abs(res.state_vector()[3]) - 2 ** -0.5) < 1e-6
dev = pennylane_device.RocQDevice(wires=2, shots=10, device="cpu")
dev.apply([qml.Hadamard(wires=0), qml.CNOT(wires=[0, 1])])
assert dev.generate_samples().shape == (10, 2)

rho = density.init_density(2, device="cpu")
rho = density.apply_gate_dm(rho, "H", [0])
rho = density.apply_channel(rho, "depolarizing", 0.1, [0, 1])
assert abs(float(density.trace_dm(rho)) - 1) < 1e-6
assert density.sample_dm(rho, [0], 5, torch.Generator()).dtype == torch.int32
re, im = pairsim.compile_pair_ir(CircuitIR(3, [GateOp("H", (0,)),
                                               GateOp("CNOT", (2,), (0,))]))(
    *pairsim.init_pair(3, torch.float64, "cpu"))
assert abs(float(re[5]) - 2 ** -0.5) < 1e-15 and float(im.abs().max()) == 0
assert float(pairdm.expval_z_pair_dm(*pairdm.init_density_pair(
    1, torch.float64, "cpu")[:1], 0, 1)) == 1.0
assert gates.PARAMETERIZED_PARTS["RY"](0.2)[1] is None
assert config.complex_from_parts([1.0], [2.0]).dtype == torch.complex64
assert convert.rho_from_reference(np.eye(2).reshape(-1) / 2).numel() == 4
assert not any(m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]
               for m in sys.modules)
print("ok")
"""


def _run_blocked(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_bell_circuit_runs_with_jax_blocked():
    _run_blocked(_BELL)


def test_df64_circuit_runs_with_jax_blocked():
    _run_blocked(_DF64)


def test_gradient_and_compiled_program_run_with_jax_blocked():
    _run_blocked(_GRADIENT)


def test_density_engine_runs_with_jax_blocked():
    _run_blocked(_DENSITY)


def test_tensornet_and_df64_readout_run_with_jax_blocked():
    _run_blocked(_TENSORNET_AND_DF64_READOUT)


def test_program_front_ends_run_with_jax_blocked():
    _run_blocked(_FRONT_ENDS)


def test_batched_dynamic_qec_and_checkpoints_run_with_jax_blocked():
    _run_blocked(_BATCHED_AND_DYNAMIC)


def test_sharded_engine_and_compat_shims_run_with_jax_blocked():
    _run_blocked(_SHARDED)


def test_relabel_and_region_dots_run_with_jax_blocked():
    _run_blocked(_RELABEL_AND_DOTS)


def test_integrations_flat_rho_and_pair_surface_run_with_jax_blocked():
    _run_blocked(_INTEGRATIONS_AND_SURFACE)


def _assert_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rocquantum_tpu"), \
                f"{path} imports {mod}"


def test_no_module_imports_jax_or_the_jax_package():
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                _assert_imports_no_jax(os.path.join(root, name))


def test_chip_scripts_import_no_jax():
    for name in ("chip_smoke.py", "chip_profile.py"):
        _assert_imports_no_jax(os.path.join(REPO, name))
