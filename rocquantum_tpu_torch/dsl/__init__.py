"""The rocq DSL's pieces the port has so far: the declarative noise model
(``rocquantum_tpu/dsl/``; the rest of that package is not ported yet)."""

from .noise import NoiseModel  # noqa: F401
