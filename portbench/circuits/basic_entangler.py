"""PennyLane's ``BasicEntanglerLayers(weights, wires, rotation)``:
``layers`` times a column of the one-parameter ``rotation`` on every
qubit, then a ring of CNOTs, CNOT(q, q + 1 mod n) for q = 0..n-1 (one
CNOT on two qubits). Configuration keys: ``num_qubits``, ``layers``,
``rotation``."""


def gates(config):
    n, rotation = config["num_qubits"], config["rotation"]
    ring = [(q, (q + 1) % n) for q in range(n)] if n > 2 else [(0, 1)]
    out, k = [], 0
    for _ in range(config["layers"]):
        for q in range(n):
            out.append((rotation, (q,), k))
            k += 1
        out += [("CX", pair, None) for pair in ring]
    return out
