"""``rocquantum_bind``: the reference's pybind11 module of this name
(bindings.cpp: MLIRCompiler :17-29, QuantumSimulator with the modern and
legacy API :31-102, QSim alias :105), on the port."""

from ..compiler.pipeline import MLIRCompiler  # noqa: F401
from ..simulator import QSim, QuantumSimulator  # noqa: F401
