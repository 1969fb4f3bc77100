"""Ecosystem device plugins (Qiskit, Cirq, PennyLane), each import-gated on
its host framework, all three on the port's ``simulator.QuantumSimulator``.

Counterpart of ``rocquantum_tpu/integrations/``. Every plugin takes
``device=None``: the card (``api.default_device()``, which raises without
CUDA) unless the caller passes ``device="cpu"``.
"""
