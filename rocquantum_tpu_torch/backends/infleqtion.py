"""Infleqtion (Superstaq) backend client (Type A, REST).

API-parity rebuild of reference rocquantum/backends/infleqtion.py:
SUPERSTAQ_API_KEY env auth.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from .base import RocqBackend, BackendAuthenticationError

INFLEQTION_API_ENDPOINT = "https://api.superstaq.infleqtion.com"


class InfleqtionBackend(RocqBackend):
    """Client for Infleqtion hardware via the Superstaq API."""

    def __init__(self, backend_name: str = "infleqtion",
                 api_endpoint: str = INFLEQTION_API_ENDPOINT):
        super().__init__(backend_name=backend_name, api_endpoint=api_endpoint)
        self.api_key = None

    def authenticate(self) -> None:
        api_key = os.getenv("SUPERSTAQ_API_KEY")
        if not api_key:
            raise BackendAuthenticationError(
                "Authentication failed: The 'SUPERSTAQ_API_KEY' environment "
                "variable is not set. Please set it to your Superstaq API "
                "key.")
        self.api_key = api_key

    def _get_auth_headers(self) -> Dict[str, str]:
        if not self.api_key:
            raise BackendAuthenticationError(
                "Client is not authenticated. Please call authenticate() "
                "first.")
        return {"Authorization": f"Bearer {self.api_key}"}

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        return {
            "target": self.backend_name,
            "shots": shots,
            "program": circuit_representation,
        }
