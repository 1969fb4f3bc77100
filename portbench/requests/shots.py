"""A ``measure_all`` job: the engine's state, then ``traffic["shots"]``
draws over every qubit (``Circuit.sample``, qubit 0 the lowest bit).

Compared, over the checked requests' draws and the reference's p(x) =
|psi_ref(x)|^2:

- ``xeb_dev``: |F - 1|, F = the summed p of all draws over (draws x
  sum_x p(x)^2); 1 for draws from p.
- ``dup_z``: the largest excess of pairs of equal draws in a request over
  independent draws from p, in standard deviations; repeated draws keep
  F at 1, and this catches them.
"""

import numpy as np

from portbench.reference import statevector as ref

NUMBERS = ("xeb_dev", "dup_z")


def answer(system, handle, cell, traffic):
    return system.sample(handle, list(range(cell.n)), traffic["shots"])


def compare(cell, traffic, checked):
    xeb_num, draws, dup_z = 0.0, 0, []
    for a, state in checked:
        shots = np.asarray(a, np.int64).ravel()
        if shots.size != traffic["shots"] or shots.min() < 0 \
                or shots.max() >= 1 << cell.n:
            return {"xeb_dev": float("inf"), "dup_z": float("inf")}
        q2, q3 = ref.power_sum(state, 2), ref.power_sum(state, 3)
        xeb_num += float(ref.probabilities_at(state, shots).sum()) / q2
        draws += shots.size
        dup_z.append(duplicate_z(shots, q2, q3))
    if not draws:
        return {"xeb_dev": float("inf"), "dup_z": float("inf")}
    return {"xeb_dev": abs(xeb_num / draws - 1), "dup_z": max(dup_z)}


def duplicate_z(shots, q2, q3):
    """How far the pairs of equal draws in ``shots`` lie above the count
    that independent draws from the reference's p would give, in its
    standard deviations (a U-statistic: mean C(S,2) q2, variance C(S,2)
    (q2 - q2^2) + 6 C(S,3) (q3 - q2^2), with q_k = sum_x p(x)^k)."""
    s = shots.size
    _, counts = np.unique(shots, return_counts=True)
    pairs = float((counts * (counts - 1) // 2).sum())
    c2, c3 = s * (s - 1) / 2, s * (s - 1) * (s - 2) / 6
    var = c2 * (q2 - q2 * q2) + 6 * c3 * max(q3 - q2 * q2, 0.0)
    return (pairs - c2 * q2) / var ** 0.5
