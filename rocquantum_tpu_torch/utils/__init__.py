from .hamiltonian import compute_hamiltonian_expectation  # noqa: F401
