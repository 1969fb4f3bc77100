"""Labeled tensors.

Counterpart of ``rocquantum_tpu/tensornet/tensor.py``: the reference's
``rocTensor`` (device pointer, dims, string labels, strides, ownership),
its N-D permutation and its einsum-spec parser. Here a tensor is a torch
tensor plus one string label per axis; torch owns layout and memory.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import config


@dataclasses.dataclass
class Tensor:
    """A device tensor with one string label per axis."""
    data: torch.Tensor
    labels: Tuple[str, ...]

    def __post_init__(self):
        self.labels = tuple(self.labels)
        if len(self.labels) != self.data.ndim:
            raise ValueError(
                f"{len(self.labels)} labels for a rank-{self.data.ndim} tensor")
        if len(set(self.labels)) != len(self.labels):
            raise ValueError(f"duplicate labels: {self.labels}")

    @classmethod
    def from_numpy(cls, array: np.ndarray, labels: Sequence[str],
                   dtype=None, device=None) -> "Tensor":
        """Upload a host array as ``dtype`` (default: the precision's
        complex dtype) to ``device`` (default: the CUDA device; pass
        ``device="cpu"`` to stay on the CPU)."""
        from ..api import default_device
        dtype = dtype or config.complex_dtype()
        device = torch.device(device) if device is not None \
            else default_device()
        data = torch.as_tensor(np.asarray(array)).to(device=device,
                                                     dtype=dtype)
        return cls(data, tuple(labels))

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def size_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def dim_of(self, label: str) -> int:
        return self.data.shape[self.labels.index(label)]

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy().astype(np.complex128)

    def __repr__(self):
        return f"Tensor(labels={self.labels}, shape={self.shape})"


def permute(tensor: Tensor, new_labels: Sequence[str]) -> Tensor:
    """Reorder axes to ``new_labels`` (a strided view, as torch permutes)."""
    new_labels = tuple(new_labels)
    if set(new_labels) != set(tensor.labels):
        raise ValueError(f"permutation {new_labels} does not match labels "
                         f"{tensor.labels}")
    perm = [tensor.labels.index(l) for l in new_labels]
    return Tensor(tensor.data.permute(perm), new_labels)


def parse_einsum_spec(spec: str):
    """Parse 'ab,bc->ac' into (input label tuples, output labels)."""
    spec = spec.replace(" ", "")
    if "->" not in spec:
        raise ValueError("einsum spec must contain '->'")
    lhs, rhs = spec.split("->")
    inputs = tuple(tuple(part) for part in lhs.split(","))
    if not lhs or any(len(p) == 0 for p in inputs):
        raise ValueError(f"malformed einsum spec: {spec!r}")
    return inputs, tuple(rhs)
