"""Quantinuum backend client (Type A, REST).

API-parity rebuild of reference rocquantum/backends/quantinuum.py:
file-based auth via CUDAQ_QUANTINUUM_CREDENTIALS JSON, Bearer token headers,
machine/count payload.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from .base import RocqBackend, BackendAuthenticationError

QUANTINUUM_API_ENDPOINT = "https://api.quantinuum.com"


class QuantinuumBackend(RocqBackend):
    """Client for Quantinuum hardware with file-based credentials."""

    def __init__(self, backend_name: str = "quantinuum",
                 api_endpoint: str = QUANTINUUM_API_ENDPOINT):
        super().__init__(backend_name=backend_name, api_endpoint=api_endpoint)
        self.auth_credentials: Optional[Dict[str, Any]] = None

    def authenticate(self) -> None:
        credentials_path = os.getenv("CUDAQ_QUANTINUUM_CREDENTIALS")
        if not credentials_path:
            raise BackendAuthenticationError(
                "Authentication failed: The 'CUDAQ_QUANTINUUM_CREDENTIALS' "
                "environment variable is not set.")
        try:
            with open(credentials_path, "r") as f:
                self.auth_credentials = json.load(f)
        except FileNotFoundError:
            raise BackendAuthenticationError(
                f"Authentication failed: Credentials file not found at "
                f"'{credentials_path}'")
        except json.JSONDecodeError:
            raise BackendAuthenticationError(
                f"Authentication failed: File at '{credentials_path}' is not "
                "valid JSON.")

    def _get_auth_headers(self) -> Dict[str, str]:
        if not self.auth_credentials:
            raise BackendAuthenticationError(
                "Client is not authenticated. Please call authenticate() "
                "first.")
        access_token = self.auth_credentials.get("access_token")
        if not access_token:
            raise BackendAuthenticationError(
                "Authentication failed: 'access_token' not found in "
                "credentials file.")
        return {"Authorization": f"Bearer {access_token}"}

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        return {
            "machine": self.backend_name,
            "count": shots,
            "program": circuit_representation,
            "language": "OPENQASM",
        }
