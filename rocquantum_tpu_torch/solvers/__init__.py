from .vqe_solver import Optimizer, SciPyOptimizer, VQE_Solver  # noqa: F401
