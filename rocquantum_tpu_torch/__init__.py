"""rocquantum_tpu_torch — the rocquantum_tpu state-vector Circuit path
(single, double and double-float precision), its kernel front end, compiled
programs, adjoint gradients, the density-matrix engine (DensityCircuit,
DensityMatrixState, noise channels, NoiseModel), the tensor-network
engine (``rocquantum_tpu_torch.tensornet``), the flat-state engine
(``compiler.interpreter.execute``/``compile_ir``, ``ops.statevec``) and the
program front ends on it (``simulator``, ``compiler.Compiler``, OpenQASM 3,
QIR, ``qcircuit``, ``core`` with ``backends``, ``cli``, ``dsl``,
``models.evolve``), batched circuits (``Circuit(batch_size=b)``), dynamic
circuits (``compiler.dynamic``), ``qec`` and ``utils`` (checkpoints,
phase timers) on PyTorch, with hand-written CUDA fused-layer kernels for
NVIDIA Hopper.

The JAX package ``rocquantum_tpu`` beside it is the reference this package
is tested against; this package imports neither it nor jax.
"""

from . import config
from .config import df64_enabled, get_precision, set_precision  # noqa: F401

from .api import (  # noqa: F401
    Simulator, Circuit, PauliOperator, CompiledProgram, compile_program,
    QuantumProgram, kernel, Kernel, adjoint, trace_kernel, build, get_expval,
    expval_on_state, grad, make_energy_fn, adjoint_grad,
)
from .compiler.ir import CircuitIR, GateOp, ParamRef  # noqa: F401
from .density_circuit import DensityCircuit  # noqa: F401
from .density_state import DensityMatrixState, Pauli  # noqa: F401
from .dsl import NoiseModel  # noqa: F401

__version__ = "0.1.0"
