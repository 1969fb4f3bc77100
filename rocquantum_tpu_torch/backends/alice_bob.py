"""Alice & Bob backend client (Type A, REST).

The reference ships this provider as a registered skeleton
(rocquantum/backends/alice_bob.py: TODO stub). Promoted here to a concrete
Type A client over the shared REST job lifecycle
(base.py submit_job/get_job_status/get_job_result): cat-qubit (logical) processors,
ALICE_BOB_API_KEY env auth, Bearer-token headers.
"""

from __future__ import annotations

from .base import TypeARestBackend


class AliceBobBackend(TypeARestBackend):
    """Client for the Alice & Bob cloud API."""

    API_KEY_ENV = "ALICE_BOB_API_KEY"
    DEFAULT_ENDPOINT = "https://api.alice-bob.com/v1"
    DEFAULT_BACKEND_NAME = "alice_bob"
    AUTH_SCHEME = "Bearer"
