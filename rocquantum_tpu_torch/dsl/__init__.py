"""The CUDA-Q-style rocq DSL: qvec registers, free gate functions, kernel
recording, noise models, and operator algebra (counterpart of
``rocquantum_tpu/dsl/``).

API-parity rebuild of the reference ``rocq/`` package
(reference: rocq/__init__.py:11-15 public surface). The reference's
``kernel.py`` was an unfinished fragment (its ``_KernelBuildContext`` was
referenced but never defined — SURVEY P2); the behavioral contract here
follows the reference's own test suite (tests/test_framework.py).
"""

from .noise import NoiseModel  # noqa: F401
from .kernel import kernel, execute, QuantumKernel  # noqa: F401
from .operator import (  # noqa: F401
    QuantumOperator,
    PauliOperator,
    HermitianOperator,
    SumOperator,
    get_expectation_value,
)
from .qvec import qvec  # noqa: F401
from .gates import h, x, y, z, s, sdg, t, tdg, rx, ry, rz, cnot, cx, cz, swap, ccx, mcx  # noqa: F401
from .backends import get_backend, StateVectorBackend, DensityMatrixBackend  # noqa: F401
