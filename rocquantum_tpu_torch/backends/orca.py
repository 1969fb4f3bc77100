"""ORCA Computing backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/orca.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): photonic boson-sampling processors,
ORCA_AUTH_TOKEN env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class OrcaBackend(TypeARestBackend):
    """Client for the ORCA Computing cloud API."""

    API_KEY_ENV = "ORCA_AUTH_TOKEN"
    DEFAULT_ENDPOINT = "https://api.orcacomputing.com/v1"
    DEFAULT_BACKEND_NAME = "orca"
    AUTH_SCHEME = "Bearer"
