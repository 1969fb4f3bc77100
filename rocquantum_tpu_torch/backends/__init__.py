"""Backends behind ``core.set_target``: the thirteen cloud-QPU clients and
the in-process ``local`` simulator. The clients are copies of
``rocquantum_tpu/backends/`` (HTTP clients, no engine of their own); the
local backend runs on this package's engine."""

from .base import (  # noqa: F401
    RocqBackend,
    BackendAuthenticationError,
    JobSubmissionError,
    ResultRetrievalError,
)
