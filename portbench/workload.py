"""What a cell runs, made from its files and the seed alone.

A configuration (``configs/<name>.json``) names its circuit generator
(``circuits/<generator>.py``) and its observable
(``observables/<name>.py``) with their sizes. A traffic mix
(``traffic/<name>.json``) names its request kind (``requests/<kind>.py``)
and says how angles are drawn. Every seed gives the same circuit and the
same amount of work; the seed changes only the angles (and so the
answers).
"""

import importlib.util
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(kind, name, root=HERE):
    """``<root>/<kind>/<name>.json``."""
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind, name, root=HERE):
    """The module ``<root>/<kind>/<name>.py``."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def circuit(config, root=HERE):
    """``[(name, qubits, param)]`` of the configuration's generator."""
    return load_module("circuits", config["generator"], root).gates(config)


def observable(config, root=HERE):
    """``[(coeff, ((pauli, qubit), ...))]`` of the configuration's
    observable."""
    spec = dict(config["observable"])
    mod = load_module("observables", spec.pop("name"), root)
    return mod.terms(config["num_qubits"], **spec)


def num_params(gates):
    return sum(p is not None for *_, p in gates)


def seed_sequence(seed, stream):
    """Independent streams from one ``--seed`` (any whole number)."""
    return np.random.SeedSequence([seed & (2**64 - 1), stream])


class Angles:
    """The angles of successive requests: fresh from the seed for each,
    uniform in the mix's ``[low, high)``. ``stream`` 0 serves the timed
    requests, 1 the warm-up."""

    def __init__(self, traffic, count, seed, stream=0):
        self.low = traffic["angles"]["low"]
        self.high = traffic["angles"]["high"]
        self.count = count
        self.rng = np.random.default_rng(seed_sequence(seed, stream))

    def next(self):
        return self.rng.uniform(self.low, self.high, self.count)


def checked_requests(completed, config, seed):
    """Indices of the requests the comparison judges: the
    configuration's ``checked`` (as many as the reference at its size
    works out in less than a window) drawn from the seed among all but
    the last, and the last (whose state is still held)."""
    if completed == 0:
        return []
    rng = np.random.default_rng(seed_sequence(seed, 2))
    k = min(config["checked"], completed - 1)
    picked = rng.choice(completed - 1, size=k, replace=False)
    return sorted(int(i) for i in picked) + [completed - 1]
