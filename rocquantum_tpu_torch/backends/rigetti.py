"""Rigetti backend via AWS Braket (Type C: cloud-intermediary SDK).

API-parity rebuild of reference rocquantum/backends/rigetti.py: boto3-based
authentication (env/shared-credential chain), create_quantum_task submission,
task-ARN status polling, measurement-count retrieval. boto3 is imported
lazily so the framework works without it installed.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .base import (RocqBackend, BackendAuthenticationError,
                   JobSubmissionError, ResultRetrievalError)

DEFAULT_AWS_REGION = "us-west-1"
RIGETTI_ASPEN_M_3_ARN = "arn:aws:braket:us-west-1::device/qpu/rigetti/Aspen-M-3"


class RigettiBackend(RocqBackend):
    """Client for Rigetti QPUs through the AWS Braket service."""

    def __init__(self, backend_name: str = "rigetti",
                 aws_region: str = DEFAULT_AWS_REGION,
                 device_arn: str = RIGETTI_ASPEN_M_3_ARN,
                 s3_bucket: str = "amazon-braket-rocq-results",
                 s3_prefix: str = "rocq-jobs"):
        super().__init__(backend_name=backend_name, api_endpoint="")
        self.aws_region = aws_region
        self.device_arn = device_arn
        self.s3_bucket = s3_bucket
        self.s3_prefix = s3_prefix
        self.braket_client = None

    def authenticate(self) -> None:
        try:
            import boto3
            from botocore.exceptions import BotoCoreError, ClientError
        except ImportError:
            raise BackendAuthenticationError(
                "boto3 is required for the Rigetti backend; install it to "
                "use AWS Braket.")
        try:
            self.braket_client = boto3.client("braket",
                                              region_name=self.aws_region)
        except (BotoCoreError, ClientError) as e:
            raise BackendAuthenticationError(
                f"Failed to create AWS Braket session: {e}")

    def _get_auth_headers(self) -> Dict[str, str]:
        return {}  # boto3 signs requests itself

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        return {
            "action": json.dumps({
                "braketSchemaHeader": {
                    "name": "braket.ir.openqasm.program",
                    "version": "1",
                },
                "source": circuit_representation,
            }),
        }

    def submit_job(self, circuit, shots: int) -> str:
        if self.braket_client is None:
            raise BackendAuthenticationError(
                "Client is not authenticated. Please call authenticate() "
                "first.")
        if not isinstance(circuit, str):
            raise JobSubmissionError(
                "This backend requires a pre-compiled QASM string.")
        try:
            response = self.braket_client.create_quantum_task(
                deviceArn=self.device_arn,
                outputS3Bucket=self.s3_bucket,
                outputS3KeyPrefix=self.s3_prefix,
                shots=shots,
                **self._build_payload(circuit, shots))
        except Exception as e:
            raise JobSubmissionError(f"Braket task submission failed: {e}")
        return response["quantumTaskArn"]

    def get_job_status(self, job_id: str) -> str:
        if self.braket_client is None:
            raise BackendAuthenticationError("Not authenticated.")
        try:
            response = self.braket_client.get_quantum_task(quantumTaskArn=job_id)
        except Exception as e:
            raise ResultRetrievalError(
                f"Failed to get Braket task status: {e}")
        status_map = {"COMPLETED": "completed", "FAILED": "failed",
                      "CANCELLED": "cancelled"}
        return status_map.get(response["status"], response["status"].lower())

    def get_job_result(self, job_id: str) -> Dict[str, int]:
        status = self.get_job_status(job_id)
        if status != "completed":
            raise ResultRetrievalError(
                f"Cannot retrieve results for task '{job_id}' because its "
                f"status is '{status}'.")
        try:
            import boto3
            task = self.braket_client.get_quantum_task(quantumTaskArn=job_id)
            s3 = boto3.client("s3", region_name=self.aws_region)
            bucket = task["outputS3Bucket"]
            key = f"{task['outputS3Directory']}/results.json"
            body = s3.get_object(Bucket=bucket, Key=key)["Body"].read()
            results = json.loads(body)
            return results.get("measurementProbabilities", {})
        except Exception as e:
            raise ResultRetrievalError(f"Failed to fetch Braket results: {e}")
