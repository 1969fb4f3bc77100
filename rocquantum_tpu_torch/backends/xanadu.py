"""Xanadu backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/xanadu.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): photonic processors (Xanadu Cloud),
XANADU_CLOUD_KEY env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class XanaduBackend(TypeARestBackend):
    """Client for the Xanadu cloud API."""

    API_KEY_ENV = "XANADU_CLOUD_KEY"
    DEFAULT_ENDPOINT = "https://platform.xanadu.ai/api/v1"
    DEFAULT_BACKEND_NAME = "xanadu"
    AUTH_SCHEME = "Bearer"
