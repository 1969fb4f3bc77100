"""Qiskit's ``QuantumVolume(num_qubits, depth)`` model circuit: ``depth``
layers, each a permutation of the qubits and a dense SU(4) on each
consecutive pair of it, ``(perm[2 w], perm[2 w + 1])`` with the first the
low bit of the gate's index (Cross et al., arXiv:1811.12926). The
permutations come from the configuration's ``structure_seed``, so every
seed of a run keeps the circuit's structure; each gate is ``("SU4",
pair, k)``, its matrix drawn fresh a request from draw k
(``reference.dense.matrix``). Configuration keys: ``num_qubits``,
``depth``, ``structure_seed``."""

import numpy as np


def gates(config):
    n = config["num_qubits"]
    rng = np.random.default_rng(config["structure_seed"])
    out = []
    for _ in range(config["depth"]):
        perm = rng.permutation(n)
        for w in range(n // 2):
            out.append(("SU4", (int(perm[2 * w]), int(perm[2 * w + 1])),
                        len(out)))
    return out
