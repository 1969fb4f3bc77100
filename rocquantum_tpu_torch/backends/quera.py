"""QuEra backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/quera.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): neutral-atom processors,
QUERA_API_KEY env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class QuEraBackend(TypeARestBackend):
    """Client for the QuEra cloud API."""

    API_KEY_ENV = "QUERA_API_KEY"
    DEFAULT_ENDPOINT = "https://api.quera.com/v1"
    DEFAULT_BACKEND_NAME = "quera"
    AUTH_SCHEME = "Bearer"
