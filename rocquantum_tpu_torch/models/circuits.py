"""Canonical circuit families: the QFT (the reference's benchmark workload,
benchmarks/run_benchmark.py:36-37), GHZ, the hardware-efficient ansatz,
QAOA MaxCut, random circuits, the inverse QFT, phase estimation and Grover
search. Copied from ``rocquantum_tpu/models/circuits.py``; each builder
returns a CircuitIR (the parameterized ones with ParamRef slots).
"""

from __future__ import annotations

import math

import numpy as np

from ..compiler.ir import CircuitIR, ParamRef


def qft_ir(n: int, include_swaps: bool = True) -> CircuitIR:
    """Quantum Fourier transform: H + controlled-phase cascade + bit
    reversal."""
    ir = CircuitIR(n, name=f"qft{n}")
    for i in range(n - 1, -1, -1):
        ir.add("H", [i])
        for j in range(i - 1, -1, -1):
            angle = math.pi / (1 << (i - j))
            ir.add("P", [i], controls=[j], params=[angle])
    if include_swaps:
        for i in range(n // 2):
            ir.add("SWAP", [i, n - 1 - i])
    return ir


def ghz_ir(n: int) -> CircuitIR:
    ir = CircuitIR(n, name=f"ghz{n}")
    ir.add("H", [0])
    for t in range(1, n):
        ir.add("CNOT", [t], controls=[0])
    return ir


def hardware_efficient_ansatz_ir(n: int, layers: int,
                                 entangler: str = "ring") -> CircuitIR:
    """RY column + CNOT entangler per layer; parameters are ParamRef slots
    (n*layers of them)."""
    ir = CircuitIR(n, name=f"hea{n}x{layers}")
    k = 0
    for _ in range(layers):
        for q in range(n):
            ir.add("RY", [q], params=[ParamRef(k)])
            k += 1
        if entangler == "ring":
            for q in range(n):
                ir.add("CNOT", [(q + 1) % n], controls=[q])
        else:  # linear
            for q in range(n - 1):
                ir.add("CNOT", [q + 1], controls=[q])
    return ir


def qaoa_maxcut_ir(n: int, p: int, edges=None) -> CircuitIR:
    """QAOA for MaxCut on a ring (or given edge list); 2p ParamRef slots
    (gamma_0, beta_0, gamma_1, ...)."""
    if edges is None:
        edges = [(q, (q + 1) % n) for q in range(n)]
    ir = CircuitIR(n, name=f"qaoa{n}p{p}")
    for q in range(n):
        ir.add("H", [q])
    k = 0
    for _ in range(p):
        gamma = ParamRef(k)
        k += 1
        for (a, b) in edges:
            # native two-qubit diagonal: RZZ(g) == CNOT - RZ(g) - CNOT,
            # but costs one masked multiply in the fused kernel
            ir.add("RZZ", [a, b], params=[gamma])  # angle scaling by caller
        beta = ParamRef(k)
        k += 1
        for q in range(n):
            ir.add("RX", [q], params=[beta])
    return ir


def random_circuit_ir(n: int, depth: int, seed: int = 0,
                      two_qubit_prob: float = 0.4) -> CircuitIR:
    """Random circuit with a fixed gate alphabet (benchmark / fuzz input)."""
    rng = np.random.default_rng(seed)
    ir = CircuitIR(n, name=f"random{n}x{depth}")
    one_q = ["H", "X", "Y", "Z", "S", "T"]
    for _ in range(depth):
        for q in range(n):
            if n > 1 and rng.random() < two_qubit_prob:
                other = int((q + 1 + rng.integers(0, n - 1)) % n)
                ir.add("CNOT", [other], controls=[q])
            elif rng.random() < 0.5:
                ir.add(str(rng.choice(one_q)), [q])
            else:
                ir.add("RY", [q], params=[float(rng.normal())])
    return ir


def inverse_qft_ir(n: int, qubits=None, ir: CircuitIR = None,
                   include_swaps: bool = True) -> CircuitIR:
    """Inverse QFT, optionally on a subset of qubits of an existing IR
    (used by phase estimation: the counting register)."""
    qs = list(qubits) if qubits is not None else list(range(n))
    if ir is None:
        ir = CircuitIR(n, name=f"iqft{len(qs)}")
    m = len(qs)
    if include_swaps:
        for i in range(m // 2):
            ir.add("SWAP", [qs[i], qs[m - 1 - i]])
    for i in range(m):
        for j in range(i):
            angle = -math.pi / (1 << (i - j))
            ir.add("P", [qs[i]], controls=[qs[j]], params=[angle])
        ir.add("H", [qs[i]])
    return ir


def qpe_ir(num_counting: int, phase: float) -> CircuitIR:
    """Quantum phase estimation of U = P(2*pi*phase) on eigenstate |1>:
    ``num_counting`` counting qubits (0..m-1, qubit j weighted 2^j) plus
    one eigenstate qubit (index m). After the run, the counting register
    peaks at round(phase * 2^m) — rides the kernel's one-pass "D2"
    controlled-phase path end to end."""
    m = num_counting
    ir = CircuitIR(m + 1, name=f"qpe{m}")
    ir.add("X", [m])  # eigenstate |1> of the phase gate
    for j in range(m):
        ir.add("H", [j])
    for j in range(m):
        # controlled-U^(2^j): phases are diagonal, so powers just scale
        angle = 2.0 * math.pi * phase * (1 << j)
        ir.add("P", [m], controls=[j], params=[angle])
    inverse_qft_ir(m + 1, qubits=list(range(m)), ir=ir)
    return ir


def grover_ir(n: int, marked: int, iterations: int = None) -> CircuitIR:
    """Grover search for the ``marked`` basis state: phase oracle (X-framed
    multi-controlled Z) + diffusion, ~pi/4*sqrt(2^n) rounds."""
    if not 0 <= marked < (1 << n):
        raise ValueError(f"marked state {marked} out of range for n={n}")
    if iterations is None:
        iterations = max(1, int(math.floor(math.pi / 4 * math.sqrt(1 << n))))
    ir = CircuitIR(n, name=f"grover{n}")
    for q in range(n):
        ir.add("H", [q])
    zeros = [q for q in range(n) if not (marked >> q) & 1]

    def mcz():
        ir.add("Z", [n - 1], controls=list(range(n - 1)))

    for _ in range(iterations):
        for q in zeros:           # oracle: phase-flip the marked state
            ir.add("X", [q])
        mcz()
        for q in zeros:
            ir.add("X", [q])
        for q in range(n):        # diffusion about the mean
            ir.add("H", [q])
            ir.add("X", [q])
        mcz()
        for q in range(n):
            ir.add("X", [q])
            ir.add("H", [q])
    return ir
