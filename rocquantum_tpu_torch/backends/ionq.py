"""IonQ backend client (Type A, REST).

API-parity rebuild of reference rocquantum/backends/ionq.py: v0.3 endpoint,
IONQ_API_KEY env auth (:58), ApiKey header, OPENQASM job payload (:84-93).
"""

from __future__ import annotations

import os
from typing import Any, Dict

from .base import RocqBackend, BackendAuthenticationError

IONQ_API_V0_3_ENDPOINT = "https://api.ionq.co/v0.3"


class IonQBackend(RocqBackend):
    """Client for the IonQ REST API (v0.3)."""

    def __init__(self, backend_name: str = "qpu",
                 api_endpoint: str = IONQ_API_V0_3_ENDPOINT):
        super().__init__(backend_name=backend_name, api_endpoint=api_endpoint)
        self.api_key = None

    def authenticate(self) -> None:
        api_key = os.getenv("IONQ_API_KEY")
        if not api_key:
            raise BackendAuthenticationError(
                "Authentication failed: The 'IONQ_API_KEY' environment "
                "variable is not set. Please set it to your IonQ API key.")
        self.api_key = api_key

    def _get_auth_headers(self) -> Dict[str, str]:
        if not self.api_key:
            raise BackendAuthenticationError(
                "Client is not authenticated. Please call authenticate() "
                "first.")
        return {"Authorization": f"ApiKey {self.api_key}"}

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        return {
            "target": self.backend_name,
            "shots": shots,
            "body": {
                "language": "OPENQASM",
                "program": circuit_representation,
            },
        }
