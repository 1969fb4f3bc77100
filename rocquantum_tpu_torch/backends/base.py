"""Cloud-QPU backend abstraction.

Ported essentially verbatim from the reference rocquantum/backends/base.py
for API parity (the ABC surface, REST flow, and error text are the contract
provider subclasses and their tests program against): typed exceptions
(:20-30), the RocqBackend ABC, and the shared Type A (REST API) job
lifecycle — submit_job POST /jobs (:61-91), get_job_status (:93-108),
get_job_result histogram (:110-131).
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Union

import requests


class BackendAuthenticationError(Exception):
    """Raised when authentication with a third-party backend API fails."""


class JobSubmissionError(Exception):
    """Raised when a job submission to the backend fails."""


class ResultRetrievalError(Exception):
    """Raised when fetching the result of a completed job fails."""


class RocqBackend(abc.ABC):
    """Interface + shared Type A REST functionality for QPU clients."""

    def __init__(self, backend_name: str, api_endpoint: str):
        self.backend_name = backend_name
        self.api_endpoint = api_endpoint

    @abc.abstractmethod
    def authenticate(self) -> None:
        """Provider-specific authentication flow."""
        raise NotImplementedError

    @abc.abstractmethod
    def _get_auth_headers(self) -> Dict[str, str]:
        """Provider-specific authorization headers."""
        raise NotImplementedError

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        raise NotImplementedError(
            "This method is for Type A backends and must be overridden.")

    def submit_job(self, circuit: Union["QuantumCircuit", str],
                   shots: int) -> str:
        """Default Type A submission: POST QASM to /jobs; returns job id."""
        if not isinstance(circuit, str):
            raise JobSubmissionError(
                "This backend requires a pre-compiled QASM string. "
                "To submit a QuantumCircuit object, use a different backend.")
        headers = self._get_auth_headers()
        headers["Content-Type"] = "application/json"
        payload = self._build_payload(circuit, shots)
        try:
            response = requests.post(f"{self.api_endpoint}/jobs",
                                     headers=headers, json=payload)
            response.raise_for_status()
        except requests.exceptions.RequestException as e:
            raise JobSubmissionError(
                f"Job submission failed due to a network error: {e}")
        response_data = response.json()
        job_id = response_data.get("id")
        if not job_id:
            raise JobSubmissionError("API response did not contain a job ID.")
        return job_id

    def get_job_status(self, job_id: str) -> str:
        try:
            response = requests.get(f"{self.api_endpoint}/jobs/{job_id}",
                                    headers=self._get_auth_headers())
            response.raise_for_status()
        except requests.exceptions.RequestException as e:
            raise ResultRetrievalError(
                f"Failed to get job status for job '{job_id}': {e}")
        status = response.json().get("status")
        if not status:
            raise ResultRetrievalError(
                f"API response for job '{job_id}' did not contain a status.")
        return status

    def get_job_result(self, job_id: str) -> Dict[str, int]:
        status = self.get_job_status(job_id)
        if status != "completed":
            raise ResultRetrievalError(
                f"Cannot retrieve results for job '{job_id}' because its "
                f"status is '{status}'.")
        try:
            response = requests.get(f"{self.api_endpoint}/jobs/{job_id}",
                                    headers=self._get_auth_headers())
            response.raise_for_status()
        except requests.exceptions.RequestException as e:
            raise ResultRetrievalError(
                f"Failed to retrieve results for job '{job_id}': {e}")
        histogram = response.json().get("data", {}).get("histogram")
        if histogram is None:
            raise ResultRetrievalError(
                f"API response for job '{job_id}' did not contain a "
                "histogram.")
        return histogram


class TypeARestBackend(RocqBackend):
    """Shared concrete Type A client: env-var API key, Bearer auth, and a
    {device, shots, program} JSON payload. Provider subclasses set the
    class attributes; override ``_build_payload`` only when a provider's
    schema differs (reference pattern: rocquantum/backends/base.py:61-131
    drives the lifecycle; the per-provider deltas are auth + payload).
    """

    #: name of the environment variable holding the API key
    API_KEY_ENV: str = ""
    #: default REST endpoint
    DEFAULT_ENDPOINT: str = ""
    #: default device/target name
    DEFAULT_BACKEND_NAME: str = ""
    #: authorization header scheme ("Bearer" -> "Authorization: Bearer k")
    AUTH_SCHEME: str = "Bearer"

    def __init__(self, backend_name: str = None, api_endpoint: str = None):
        super().__init__(
            backend_name=backend_name or self.DEFAULT_BACKEND_NAME,
            api_endpoint=api_endpoint or self.DEFAULT_ENDPOINT)
        self.api_key = None

    def authenticate(self) -> None:
        import os
        api_key = os.getenv(self.API_KEY_ENV)
        if not api_key:
            raise BackendAuthenticationError(
                f"Authentication failed: The '{self.API_KEY_ENV}' "
                "environment variable is not set. Please set it to your "
                f"{self.DEFAULT_BACKEND_NAME} API key.")
        self.api_key = api_key

    def _get_auth_headers(self) -> Dict[str, str]:
        if not self.api_key:
            raise BackendAuthenticationError(
                "Client is not authenticated. Please call authenticate() "
                "first.")
        if self.AUTH_SCHEME:
            return {"Authorization": f"{self.AUTH_SCHEME} {self.api_key}"}
        return {"Authorization": self.api_key}

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        return {
            "device": self.backend_name,
            "shots": shots,
            "program": circuit_representation,
        }
