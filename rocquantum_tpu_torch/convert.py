"""Carry the JAX package's inputs across to this package.

A circuit's "weights" are its IR and its parameter vector. These functions
turn the reference's objects into the port's, so the tests can feed both
packages the same thing. They read the reference's fields by name (duck
typing) and import nothing from ``rocquantum_tpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .compiler.ir import CircuitIR, GateOp, ParamRef


def _param(p):
    index = getattr(p, "index", None)
    if index is not None and not isinstance(p, (int, float, np.number)):
        return ParamRef(int(index))
    return float(p)


def ir_from_reference(ir) -> CircuitIR:
    """A JAX-package ``CircuitIR`` as this package's ``CircuitIR``: reads
    ``num_qubits``, ``name`` and, per op, ``name``, ``targets``,
    ``controls``, ``params`` (``ParamRef.index``), ``matrix`` and
    ``is_adjoint``."""
    ops = []
    for op in ir.ops:
        matrix = None if op.matrix is None else np.asarray(op.matrix)
        ops.append(GateOp(str(op.name), tuple(int(t) for t in op.targets),
                          tuple(int(c) for c in op.controls),
                          tuple(_param(p) for p in op.params), matrix,
                          bool(op.is_adjoint)))
    return CircuitIR(int(ir.num_qubits), ops, name=str(ir.name))


def params_from_numpy(values, device=None) -> torch.Tensor:
    """A parameter vector as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def state_from_numpy(re, im, device=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A float-pair state as float32 planes on ``device`` (``im`` None for
    a real state)."""
    out_re = torch.as_tensor(np.asarray(re, np.float32).reshape(-1),
                             device=device).contiguous()
    if im is None:
        return out_re, None
    out_im = torch.as_tensor(np.asarray(im, np.float32).reshape(-1),
                             device=device).contiguous()
    return out_re, out_im
