"""Carry the JAX package's inputs across to this package.

A circuit's "weights" are its IR and its parameter vector; a tensor
network's are its labeled tensors. These functions turn the reference's
objects into the port's, so the tests can feed both packages the same
thing. They read the reference's fields by name (duck
typing) and import nothing from ``rocquantum_tpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .compiler.ir import CircuitIR, GateOp, ParamRef
from .tensornet.contraction import TensorNetwork
from .tensornet.tensor import Tensor


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


def params_from_numpy(values, device=None, dtype=np.float32) -> torch.Tensor:
    """A parameter vector as a ``dtype`` (float32 or float64) tensor on
    ``device``."""
    return torch.as_tensor(np.asarray(values, dtype), device=device)


def state_from_numpy(re, im, device=None, dtype=np.float32
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A float-pair state as ``dtype`` (float32 or float64) planes on
    ``device`` (``im`` None for a real state)."""
    out_re = torch.as_tensor(np.ascontiguousarray(re, dtype).reshape(-1),
                             device=device).contiguous()
    if im is None:
        return out_re, None
    out_im = torch.as_tensor(np.ascontiguousarray(im, dtype).reshape(-1),
                             device=device).contiguous()
    return out_re, out_im


def state_from_reference(state, device=None, dtype=None) -> torch.Tensor:
    """A flat JAX complex state (as a numpy array, or the ``(re, im)``
    pair of its float-pair engines) as this package's flat complex tensor
    on ``device``. ``dtype`` defaults to the input's complex precision
    (complex64 for float32 parts, else complex128)."""
    if isinstance(state, (tuple, list)):
        re, im = (np.asarray(p) for p in state)
    else:
        state = np.asarray(state)
        re, im = state.real, state.imag
    if dtype is None:
        dtype = torch.complex64 if re.dtype == np.float32 \
            else torch.complex128
    z = np.ascontiguousarray(re, np.float64).reshape(-1) \
        + 1j * np.ascontiguousarray(im, np.float64).reshape(-1)
    return torch.as_tensor(z, device=device).to(dtype)


def density_from_reference(rho, device=None, dtype=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's rho as this package's planes ``(re, im)`` of the
    flattened ``(4^n,)`` view, row index high: ``rho`` is a complex
    ``(4^n,)`` or ``(2^n, 2^n)`` array, or the ``(re, im)`` pair of the
    double engine. ``dtype`` defaults to the input's real precision
    (float32 for complex64, else float64)."""
    # copies: the reference's arrays are read-only, the planes are not
    if isinstance(rho, (tuple, list)):
        re, im = (np.array(p) for p in rho)
    else:
        rho = np.asarray(rho)
        re, im = np.array(rho.real), np.array(rho.imag)
    if dtype is None:
        dtype = np.float32 if re.dtype == np.float32 else np.float64
    return state_from_numpy(re, im, device=device, dtype=dtype)


def rho_from_reference(rho, device=None, dtype=None) -> torch.Tensor:
    """The JAX package's flat complex rho (``ops/density.py``: a complex
    ``(4^n,)`` or ``(2^n, 2^n)`` array) as this package's flat complex
    ``(4^n,)`` tensor on ``device``; rho is a 2n-qubit state, so this is
    :func:`state_from_reference` of its flattening."""
    return state_from_reference(np.asarray(rho).reshape(-1), device=device,
                                dtype=dtype)


def df64_from_reference(state, device=None):
    """The JAX package's df64 state ``(re_hi, re_lo, im_hi, im_lo)`` as
    this package's four float32 planes on ``device``."""
    return tuple(torch.as_tensor(np.array(p, np.float32).reshape(-1),
                                 device=device) for p in state)


def tensor_from_reference(t, device=None) -> Tensor:
    """A JAX-package ``Tensor`` (its ``labels`` and ``data``, dtype kept)
    as this package's ``Tensor`` on ``device``."""
    return Tensor(torch.as_tensor(np.array(t.data), device=device),
                  tuple(t.labels))


def network_from_reference(tn, device) -> TensorNetwork:
    """A JAX-package ``TensorNetwork`` (its tensors and memory limit) as
    this package's on ``device``."""
    out = TensorNetwork(memory_limit_bytes=tn.memory_limit_bytes,
                        device=device)
    for t in tn.tensors:
        out.add_tensor(tensor_from_reference(t, device))
    return out
