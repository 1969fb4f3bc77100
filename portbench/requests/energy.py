"""One VQE energy evaluation: the engine's state, then its expectation
of the configuration's observable (``Circuit.expval`` on the program,
the reference's Pauli sums on the control).

Compared: ``energy_err``, the largest |E - E_ref| / sum_k |c_k| over the
checked requests."""

from portbench.reference import statevector as ref

NUMBERS = ("energy_err",)


def answer(system, handle, cell, traffic):
    return system.expval(handle, cell.terms)


def compare(cell, traffic, checked):
    """``checked`` yields ``(answer, reference state)`` one request at a
    time."""
    scale = sum(abs(c) for c, _ in cell.terms)
    errs = [abs(float(a) - ref.energy(state, cell.terms)) / scale
            for a, state in checked]
    return {"energy_err": max(errs, default=float("inf"))}
