"""Quantum Machines backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/quantum_machines.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): OPX-controlled processors,
QM_API_KEY env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class QuantumMachinesBackend(TypeARestBackend):
    """Client for the Quantum Machines cloud API."""

    API_KEY_ENV = "QM_API_KEY"
    DEFAULT_ENDPOINT = "https://api.quantum-machines.co/v1"
    DEFAULT_BACKEND_NAME = "quantum_machines"
    AUTH_SCHEME = "Bearer"
