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


def test_relabel_and_region_dots_run_with_jax_blocked():
    _run_blocked(_RELABEL_AND_DOTS)


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
