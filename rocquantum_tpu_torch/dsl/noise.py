"""Declarative noise model: noise-channel specs that a density-matrix
circuit applies after the gates they name (a copy of
``rocquantum_tpu/dsl/noise.py``, which the port cannot import)."""

from __future__ import annotations


class NoiseModel:
    """Collects noise-channel specs applied during execution on a
    density-matrix circuit.

        >>> noise_model = NoiseModel()
        >>> noise_model.add_channel('depolarizing', 0.01, on_qubits=[0, 1])
        >>> noise_model.add_channel('bit_flip', 0.005, after_op='cnot')
    """

    def __init__(self):
        self._channels = []

    def add_channel(self, channel_type: str, probability: float,
                    on_qubits=None, after_op: str = None):
        if not isinstance(probability, (int, float)) or not (
                0 <= probability <= 1):
            raise ValueError("Probability must be between 0 and 1.")
        self._channels.append({
            "type": channel_type,
            "prob": probability,
            "qubits": list(on_qubits) if on_qubits is not None else None,
            "op": after_op.lower() if after_op else None,
        })

    def get_channels(self):
        return self._channels
