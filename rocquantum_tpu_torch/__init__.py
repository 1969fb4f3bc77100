"""rocquantum_tpu_torch — the rocquantum_tpu f32 state-vector Circuit path
on PyTorch, with a hand-written CUDA fused-layer kernel for NVIDIA Hopper.

The JAX package ``rocquantum_tpu`` beside it is the reference this package
is tested against; this package imports neither it nor jax.
"""

from . import config
from .config import set_precision, get_precision  # noqa: F401

from .api import Simulator, Circuit, PauliOperator  # noqa: F401
from .compiler.ir import CircuitIR, GateOp, ParamRef  # noqa: F401

__version__ = "0.1.0"
