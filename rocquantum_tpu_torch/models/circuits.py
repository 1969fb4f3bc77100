"""Canonical circuit families: the QFT (the reference's benchmark workload,
benchmarks/run_benchmark.py:36-37), GHZ and the hardware-efficient ansatz.
Copied from ``rocquantum_tpu/models/circuits.py``; each builder returns a
CircuitIR (the ansatz with ParamRef slots).
"""

from __future__ import annotations

import math

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
