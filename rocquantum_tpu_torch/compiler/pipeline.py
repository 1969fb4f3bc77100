"""Compiler pipeline facade (counterpart of
``rocquantum_tpu/compiler/pipeline.py``).

API-parity rebuild of the reference's two MLIRCompiler classes
(reference: rocqCompiler/MLIRCompiler.cpp:47-88 — emit_qir running
QuantumToSimulator + SimulatorToQIR + LLVM lowering; and
rocquantum/src/rocqCompiler/MLIRCompiler.cpp:26-127 —
initializeModule/loadModuleFromString/getModuleString/dump; plus the
run_adjoint_generation_pass binding, python/rocq/bindings.cpp:701).

The lowering pipeline is circuit IR -> (fusion, adjoint) passes -> the
planned program of ``compile_ir`` (fused kernel passes on the card); the
textual circuit IR plays the MLIR-module role and ``emit_qir`` prints QIR
text. The JAX package's ``emit_stablehlo`` prints XLA's own IR of its
jitted program, which has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

from .ir import CircuitIR
from .passes import adjoint_ir, plan_fusion
from .interpreter import compile_ir


class Compiler:
    """Module-holder + pass-runner + lowering entry points."""

    def __init__(self, num_qubits: int = 0, backend_name: str = "statevec"):
        self.backend_name = backend_name
        self.module: Optional[CircuitIR] = None
        if num_qubits:
            self.initialize_module("module", num_qubits)

    # -- module management (C6 parity) --------------------------------------

    def initialize_module(self, name: str, num_qubits: int = 0) -> bool:
        self.module = CircuitIR(num_qubits, name=name)
        return True

    def load_module(self, ir: CircuitIR) -> bool:
        self.module = ir
        return True

    def load_module_from_string(self, text: str) -> bool:
        """Parse a textual module. OpenQASM 3 is the accepted exchange
        syntax (the reference parsed its conceptual-MLIR strings)."""
        try:
            from .qasm_parser import parse_qasm3
            self.module = parse_qasm3(text)
            return True
        except ValueError:
            return False

    def get_module_string(self) -> str:
        if self.module is None:
            return ""
        return self.module.dump()

    def dump_module(self):
        print(self.get_module_string())

    # -- passes (C3/C4/C7 parity) --------------------------------------------

    def run_adjoint_generation_pass(self) -> bool:
        """Append the adjoint of the current module (AdjointGeneration.cpp
        semantics: clone reversed with is_adjoint toggled)."""
        if self.module is None:
            return False
        self.adjoint_module = adjoint_ir(self.module)
        return True

    def run_fusion_pass(self, max_fuse: int = 2):
        """Return the fusion plan for inspection (GateFusion::processQueue
        analog)."""
        if self.module is None:
            return []
        return plan_fusion(list(self.module.ops), max_fuse=max_fuse)

    # -- lowering (C5 parity) --------------------------------------------------

    def emit_qir(self, text: Optional[str] = None) -> str:
        """Emit QIR-shaped LLVM IR text: ``call void
        @__quantum__qis__<name>__body(...)`` per gate — the reference's
        declared output contract (SimulatorToQIRPass.cpp:33-40, verified
        by example.py:21-27)."""
        if text is not None:
            if not self.load_module_from_string(text):
                raise ValueError("failed to parse module text")
        if self.module is None:
            raise RuntimeError("no module loaded")
        from .qir import emit_qir_text
        return emit_qir_text(self.module)

    def emit_stablehlo(self, text: Optional[str] = None) -> str:
        """Not available: StableHLO is XLA's IR of a jitted program, and
        this package runs planned kernel passes, not XLA programs."""
        raise NotImplementedError(
            "emit_stablehlo lowers to XLA's StableHLO, which this package "
            "does not use; emit_qir gives the program's QIR text")

    def compile(self, fuse: bool = True):
        """Compile the module to ``f(state, params) -> state`` over flat
        complex states (interpreter.compile_ir)."""
        if self.module is None:
            raise RuntimeError("no module loaded")
        return compile_ir(self.module, fuse=fuse)


# Reference-compat alias (bindings exposed the class as MLIRCompiler)
MLIRCompiler = Compiler
