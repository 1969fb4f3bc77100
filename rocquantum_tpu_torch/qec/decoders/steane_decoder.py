"""Syndrome decoder for the Steane [[7,1,3]] code: Hamming-position lookup.

Syndrome layout matches SteaneCode.generate_stabilizer_circuits — bits 0-2
are the Z-type checks (locate a single X error), bits 3-5 the X-type checks
(locate a single Z error); each triple reads the 1-indexed error position
in binary.
"""

from __future__ import annotations

from typing import List

from ...api import PauliOperator
from ..framework import Decoder


class SteaneDecoder(Decoder):
    def decode(self, syndrome: List[int]) -> PauliOperator:
        if len(syndrome) != 6:
            raise ValueError("Steane syndrome has 6 bits")
        z_checks = syndrome[:3]   # fire on X errors
        x_checks = syndrome[3:]   # fire on Z errors
        terms = {}
        pos_x = z_checks[0] | (z_checks[1] << 1) | (z_checks[2] << 2)
        if pos_x:
            terms[f"X{pos_x - 1}"] = 1.0
        pos_z = x_checks[0] | (x_checks[1] << 1) | (x_checks[2] << 2)
        if pos_z:
            key = f"Z{pos_z - 1}"
            if f"X{pos_z - 1}" in terms:   # same qubit: Y = iXZ correction
                del terms[f"X{pos_z - 1}"]
                terms[f"Y{pos_z - 1}"] = 1.0
            else:
                terms[key] = 1.0
        return PauliOperator(terms) if terms else PauliOperator()
