"""SEEQC backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/seeqc.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): digital-SFQ superconducting processors,
SEEQC_API_KEY env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class SeeqcBackend(TypeARestBackend):
    """Client for the SEEQC cloud API."""

    API_KEY_ENV = "SEEQC_API_KEY"
    DEFAULT_ENDPOINT = "https://api.seeqc.com/v1"
    DEFAULT_BACKEND_NAME = "seeqc"
    AUTH_SCHEME = "Bearer"
