"""``rocq_hip``: the reference's pybind11 density-matrix module
(rocquantum/src/python/py_hip_density_mat.cpp: DensityMatrixState :44-97,
Pauli :99-103), on the port."""

from ..density_state import DensityMatrixState, Pauli  # noqa: F401
