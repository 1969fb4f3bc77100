"""IQM backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/iqm.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): superconducting processors (Resonance service),
IQM_TOKEN env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class IQMBackend(TypeARestBackend):
    """Client for the IQM cloud API."""

    API_KEY_ENV = "IQM_TOKEN"
    DEFAULT_ENDPOINT = "https://cocos.resonance.meetiqm.com"
    DEFAULT_BACKEND_NAME = "iqm"
    AUTH_SCHEME = "Bearer"
