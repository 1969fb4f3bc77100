"""The PyTorch port stands without JAX: it imports, and runs a circuit,
in a process where importing jax (or the JAX package) fails."""

import ast
import os
import subprocess
import sys

import rocquantum_tpu_torch

PKG_DIR = os.path.dirname(rocquantum_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_BELL = r"""
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "rocquantum_tpu"):
        del sys.modules[name]
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["rocquantum_tpu"] = None

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


def test_bell_circuit_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _BELL], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_module_imports_jax_or_the_jax_package():
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
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
