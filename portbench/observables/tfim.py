"""The transverse-field Ising ring: -j sum_i Z_i Z_{i+1 mod n} - h sum_i
X_i, as ``(coeff, term)`` pairs, a term a tuple of ``(pauli, qubit)``."""


def terms(n, j, h):
    zz = [(-j, (("Z", q), ("Z", (q + 1) % n))) for q in range(n)]
    return zz + [(-h, (("X", q),)) for q in range(n)]
