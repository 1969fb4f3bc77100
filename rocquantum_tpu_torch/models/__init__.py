from .circuits import (  # noqa: F401
    qft_ir, ghz_ir, hardware_efficient_ansatz_ir,
)
