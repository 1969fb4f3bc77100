from .circuits import (  # noqa: F401
    qft_ir, ghz_ir, random_circuit_ir, qaoa_maxcut_ir,
    hardware_efficient_ansatz_ir, inverse_qft_ir, qpe_ir, grover_ir,
)
from .evolution import trotter_ir, evolve  # noqa: F401
