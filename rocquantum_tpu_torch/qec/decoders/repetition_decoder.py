"""Lookup-table decoder for the 3-qubit repetition code
(reference rocquantum/qec/decoders/repetition_decoder.py:19-39)."""

from __future__ import annotations

from typing import List

from ...api import PauliOperator
from ..framework import Decoder


class RepetitionCodeDecoder(Decoder):
    """Decodes the [Z0Z1, Z1Z2] syndrome to locate a single X error."""

    def decode(self, syndrome: List[int]) -> PauliOperator:
        if syndrome == [0, 0]:
            return PauliOperator()          # no error
        if syndrome == [1, 0]:
            return PauliOperator({"X0": 1.0})
        if syndrome == [1, 1]:
            return PauliOperator({"X1": 1.0})
        if syndrome == [0, 1]:
            return PauliOperator({"X2": 1.0})
        return PauliOperator()              # uncorrectable multi-error
