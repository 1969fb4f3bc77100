"""Qiskit's ``EfficientSU2(n, su2_gates, entanglement, reps)``: ``reps``
times a column of each of ``su2_gates`` on every qubit, then CX over the
entanglement's pairs, and a last column of each of ``su2_gates``.
Entanglement ``circular`` is CX(n-1, 0) then CX(q, q + 1) for q =
0..n-2; ``linear`` leaves out the first. Configuration keys:
``num_qubits``, ``reps``, ``su2_gates``, ``entanglement``."""


def pairs(n, entanglement):
    linear = [(q, q + 1) for q in range(n - 1)]
    if entanglement == "linear":
        return linear
    if entanglement == "circular":
        return ([(n - 1, 0)] if n > 2 else []) + linear
    raise ValueError(f"no entanglement {entanglement!r}")


def gates(config):
    n = config["num_qubits"]
    cx = [("CX", p, None) for p in pairs(n, config["entanglement"])]
    out, k = [], 0

    def rotations():
        nonlocal k
        for name in config["su2_gates"]:
            for q in range(n):
                out.append((name.upper(), (q,), k))
                k += 1

    for _ in range(config["reps"]):
        rotations()
        out.extend(cx)
    rotations()
    return out
