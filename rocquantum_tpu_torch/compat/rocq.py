"""``rocq``: the reference's DSL and main-API surface (counterpart of the
repository's ``rocq/__init__.py``): the CUDA-Q-style DSL (reference
rocq/__init__.py:11-15), the Simulator/Circuit programming model
(reference python/rocq/api.py) as ``api`` and at top level, the DSL
``backends`` and ``TensorNetwork``."""

from .. import api  # noqa: F401
from ..api import (  # noqa: F401
    Circuit,
    Kernel,
    PauliOperator,
    QuantumProgram,
    Simulator,
    adjoint,
    adjoint_grad,
    build,
    get_expval,
    grad,
)
from ..dsl import (  # noqa: F401
    HermitianOperator,
    NoiseModel,
    QuantumKernel,
    QuantumOperator,
    SumOperator,
    backends,
    ccx,
    cnot,
    cx,
    cz,
    execute,
    get_backend,
    get_expectation_value,
    h,
    kernel,
    mcx,
    qvec,
    rx,
    ry,
    rz,
    s,
    sdg,
    swap,
    t,
    tdg,
    x,
    y,
    z,
)
from ..tensornet import TensorNetwork  # noqa: F401
from . import _rocq_hip_backend  # noqa: F401
