from .ir import CircuitIR, GateOp, ParamRef  # noqa: F401
from .passes import adjoint_ir, plan_fusion, FusedBlock  # noqa: F401
from .interpreter import (apply_op, clear_cache, compile_pair32_ir,  # noqa: F401
                          execute_pair, parametrize)
from .qasm import to_qasm3  # noqa: F401
