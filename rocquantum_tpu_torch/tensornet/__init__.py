"""Tensor networks on PyTorch: labeled tensors, contraction-order search,
a contraction executor with memory-limited slicing, and tensor SVD.
Counterpart of ``rocquantum_tpu/tensornet``, with the same exports."""

from .tensor import Tensor, permute, parse_einsum_spec  # noqa: F401
from .pathfinder import (  # noqa: F401
    ContractionPlan, ContractionStep, Pathfinder, PathfinderAlgorithm,
    OptimizerConfig)
from .contraction import TensorNetwork, contract_pair, tensor_svd, contract_einsum  # noqa: F401
