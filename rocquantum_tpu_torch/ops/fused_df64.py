"""Fused gate-layer pass on the double-float (df64) state: the counterpart
of ``rocquantum_tpu/ops/pallas_df64.py``.

:func:`apply_fused_layer_df64` applies an ordered list of gate specs to
every amplitude of a df64 state in one pass, in compensated float32
arithmetic. The state is flat ``(2^n,)`` float32 planes ``(re_hi, re_lo,
im_hi, im_lo)``; ``im_hi = im_lo = None`` is the real carry (every gate
real, half the planes). On CUDA tensors it launches the hand-written kernel
in ``csrc/fused_df64.cu`` (built with nvcc at first use, updated in place);
on CPU tensors it runs :func:`apply_fused_layer_df64_reference`, the
plain-torch version the tests and ``chip_smoke.py`` hold the kernel
against.

Specs are those of ops/fused_sv.py (kinds U, CNOT, CU, D2), and so is the
way a pass runs: the f32 kernel's scheduler (``fused_sv.pass_schedule``
with :data:`RULE`) plans tiles, register and thread layouts and exchanges,
and the records go to the kernel by value, each entry as ``(re_hi, re_lo,
im_hi, im_lo)``. Which specs a pass may take, on either carry: targets in
the low :data:`W_BITS` bits or in at most :data:`MAX_PAIRS` pair bits above
them, so a tile holds at most 2^13 amplitudes; the pass planner takes the
same (:func:`plan_geometry`). ``gate_mats`` is ``(K, 2, 2, 4)`` float32
``[k, row, col, (re_hi, re_lo, im_hi, im_lo)]`` (:func:`pack_gate_mats_df64`).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import _build, fused_sv
from .df64 import df_add, df_mul, df_neg
from .fused_sv import _check_specs, _normalize_specs
from .statevec import exposed_view_dims, num_qubits_of

W_BITS = fused_sv.W_BITS        # low local bits any pass may target
MAX_PAIRS = 3                   # targeted bits above the window, either carry
REG_BITS = 5                    # amplitudes a thread: 2^5 on the real carry
REG_BITS_COMPLEX = 4            # and 2^4 on the complex one
MAX_OPS = 96                    # gate and swap records of one launch
MAX_LAYOUTS = 8
KINDS = fused_sv.KINDS - {"U4"}  # the gate kinds a pass applies

_OP_DTYPE = np.dtype([("kind", np.uint8), ("real", np.uint8),
                      ("t", np.uint8), ("pad", np.uint8), ("a", np.int16),
                      ("b", np.int16), ("m", np.float32, 16)])
_PARAMS_DTYPE = np.dtype([
    ("n", np.int32), ("w", np.int32), ("tile_bits", np.int32),
    ("reg_bits", np.int32), ("num_ops", np.int32), ("pad", np.int32),
    ("lbits", np.int8, 16), ("layouts", np.int8, (MAX_LAYOUTS, 16)),
    ("ops", _OP_DTYPE, MAX_OPS)])
assert _OP_DTYPE.itemsize == 72 and _PARAMS_DTYPE.itemsize == 7080

# kernel launches in this process (a pass split into several launches
# counts each)
LAUNCHES = 0

_LIB = None


def reg_bits(tile_bits: int, complex_carry: bool) -> int:
    """Register bits per thread of a launch, whatever its tile: hi and lo
    of 2^5 amplitudes (64 registers) on the real carry, of 2^4 complex ones
    on the complex carry."""
    return REG_BITS_COMPLEX if complex_carry else REG_BITS


# R is fixed, so a launch with exchanges is never re-planned at fewer
RULE = fused_sv.Rule(reg_bits, None, MAX_OPS, MAX_LAYOUTS)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("fused_df64")
        fn = lib.rocq_fused_pass_df64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6
        _LIB = lib
    return _LIB


def window_bits(n: int) -> int:
    """Low local bits of a pass on an n-qubit state."""
    return min(W_BITS, n)


def plan_geometry(n: int, complex_carry: bool) -> Tuple[int, int]:
    """The pass planner's (reach, max_pairs) for this kernel, the same on
    either carry: the window and :data:`MAX_PAIRS` pair bits. (On the real
    carry, reach 7 and 5 pair bits plan 35 passes for the n = 26, 8-layer
    ring ansatz instead of 43, but of 2^12-amplitude tiles that need
    exchanges; the 43 ran faster, PERF.md.)"""
    return window_bits(n), MAX_PAIRS


def pack_gate_mats_df64(mats: List[np.ndarray]) -> np.ndarray:
    """Host 2x2 complex128 matrices -> one ``(K, 2, 2, 4)`` float32 array of
    hi/lo-split entries."""
    m = np.asarray(mats, np.complex128).reshape(-1, 2, 2)
    out = np.empty(m.shape + (4,), np.float32)
    for part, x in ((0, m.real), (2, m.imag)):
        hi = x.astype(np.float32)
        out[..., part] = hi
        out[..., part + 1] = (x - hi.astype(np.float64)).astype(np.float32)
    return out


def _check_layer(planes, specs, gate_mats, pair_bits, real_flags):
    """Validate a call; returns (n, specs, pair_bits, real_flags)."""
    rh, rl, ih, il = planes
    if (ih is None) != (il is None):
        raise ValueError("im_hi and im_lo must both be given or both None")
    n = num_qubits_of(rh)
    specs = _normalize_specs(specs, KINDS)
    if real_flags is None:
        real_flags = (False,) * len(specs)
    real_flags = tuple(bool(f) for f in real_flags)
    if len(real_flags) != len(specs):
        raise ValueError("real_flags length must match specs")
    if ih is None and not all(real_flags):
        raise ValueError("the real carry (im planes None) requires every "
                         "gate matrix to be real")
    if tuple(np.shape(gate_mats)) != (len(specs), 2, 2, 4):
        raise ValueError(f"gate_mats must have shape ({len(specs)}, 2, 2, 4)"
                         f", got {tuple(np.shape(gate_mats))}")
    pair_bits = _check_specs(n, specs, pair_bits, window_bits(n), MAX_PAIRS)
    return n, specs, pair_bits, real_flags


def pass_schedule(n: int, specs, complex_carry: bool):
    """The kernel launches of one pass (normalized ``specs`` that
    :func:`_check_layer` accepted): the f32 kernel's scheduler within this
    kernel's :data:`RULE`."""
    return fused_sv.pass_schedule(n, specs, complex_carry, RULE)


def launch_params(n: int, launch, gate_mats, real_flags) -> np.ndarray:
    """The kernel's parameter block for one launch (a numpy scalar of
    ``_PARAMS_DTYPE``, laid out as ``PassParams`` in csrc/fused_df64.cu)."""
    return fused_sv.pack_launch(n, launch, gate_mats, real_flags,
                                _PARAMS_DTYPE)


def apply_fused_layer_df64(rh: torch.Tensor, rl: torch.Tensor,
                           ih: Optional[torch.Tensor],
                           il: Optional[torch.Tensor],
                           specs: Sequence[tuple], gate_mats,
                           pair_bits: Sequence[int] = (),
                           real_flags: Sequence[bool] = None):
    """Apply ``specs`` to the df64 state in one pass; returns ``(rh, rl,
    ih, il)``.

    On CUDA the planes are updated in place and returned; on the CPU the
    plain reference returns new planes. Raises ``ValueError`` on specs the
    pass cannot take and ``RuntimeError`` when the launch fails."""
    with profiling.span("rq.run.pass"):
        return _apply_fused_layer_df64(rh, rl, ih, il, specs, gate_mats,
                                       pair_bits, real_flags)


def _apply_fused_layer_df64(rh, rl, ih, il, specs, gate_mats, pair_bits,
                            real_flags):
    planes = (rh, rl, ih, il)
    n, specs, pair_bits, real_flags = _check_layer(
        planes, specs, gate_mats, pair_bits, real_flags)
    device = rh.device
    if device.type != "cuda":
        return apply_fused_layer_df64_reference(
            rh, rl, ih, il, specs, gate_mats, real_flags=real_flags)
    for name, plane in zip(("rh", "rl", "ih", "il"), planes):
        if plane is not None:
            fused_sv._check_plane(name, plane, n, device)
    if not specs:
        return planes
    if isinstance(gate_mats, torch.Tensor):
        gate_mats = gate_mats.detach().cpu().numpy()
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = build()
    ptrs = [None if p is None else p.data_ptr() for p in planes]
    global LAUNCHES
    for launch in pass_schedule(n, specs, ih is not None):
        params = launch_params(n, launch, gate_mats, real_flags)
        LAUNCHES += 1
        err = lib.rocq_fused_pass_df64(*ptrs, params.ctypes.data, stream)
        if err != 0:
            raise RuntimeError(f"fused_df64 kernel launch failed: cudaError_t "
                               f"{err} (n={n}, pair_bits={pair_bits}, "
                               f"{len(specs)} gates)")
    return planes


def apply_fused_layer_df64_reference(rh, rl, ih, il, specs, gate_mats,
                                     pair_bits=(), real_flags=None):
    """Plain-torch version of :func:`apply_fused_layer_df64`: applies the
    specs in order to the full flat planes through strided views, with the
    kernel's order of df64 operations and no notion of its local set
    (``pair_bits`` is accepted and ignored). Returns new planes; the inputs
    are not modified."""
    specs = _normalize_specs(specs, KINDS)
    if real_flags is not None and ih is None and not all(real_flags):
        raise ValueError("the real carry (im planes None) requires every "
                         "gate matrix to be real")
    planes = [None if p is None else p.clone() for p in (rh, rl, ih, il)]
    n = num_qubits_of(planes[0])
    if isinstance(gate_mats, torch.Tensor):
        gate_mats = gate_mats.detach().cpu().numpy()
    mats = np.asarray(gate_mats, np.float32).reshape(-1, 2, 2, 4)
    flags = real_flags if real_flags is not None else (False,) * len(specs)
    for spec, m, real in zip(specs, mats, flags):
        # coefficients as ((re_hi, re_lo), (im_hi, im_lo)) Python floats
        c = [[((float(m[i, j, 0]), float(m[i, j, 1])),
               (float(m[i, j, 2]), float(m[i, j, 3]))) for j in range(2)]
             for i in range(2)]
        kind = spec[0]
        if kind == "D2":
            _ref_diag(planes, n, spec[1], spec[2], c, real)
        elif kind == "CNOT":
            _ref_cnot(planes, n, spec[1], spec[2])
        elif kind == "U":
            _ref_pair(planes, n, spec[1], None, c, real)
        else:
            _ref_pair(planes, n, spec[2], spec[1], c, real)
    return tuple(planes)


def _views(planes, n, bits_desc):
    dims = exposed_view_dims(n, bits_desc)
    return [None if p is None else p.view(dims) for p in planes]


def _cmul(u, x_re, x_im):
    """(re, im) of the complex df64 product u * x, in the kernel's order."""
    (ur, ui) = u
    return (df_add(df_mul(ur, x_re), df_neg(df_mul(ui, x_im))),
            df_add(df_mul(ur, x_im), df_mul(ui, x_re)))


def _pair_index(desc, target, control):
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    idx = [slice(None)] * (2 * len(desc) + 1)
    if control is not None:
        idx[axis[control]] = 1
    idx0, idx1 = list(idx), list(idx)
    idx0[axis[target]] = 0
    idx1[axis[target]] = 1
    return tuple(idx0), tuple(idx1)


def _ref_cnot(planes, n, control, target):
    desc = sorted({control, target}, reverse=True)
    idx0, idx1 = _pair_index(desc, target, control)
    for v in _views(planes, n, desc):
        if v is not None:
            x0 = v[idx0].clone()
            v[idx0] = v[idx1]
            v[idx1] = x0


def _ref_pair(planes, n, target, control, c, real):
    """2x2 ``c`` on ``target`` where ``control`` (if any) is 1, in place."""
    bits = [target] if control is None else [target, control]
    desc = sorted(bits, reverse=True)
    idx0, idx1 = _pair_index(desc, target, control)
    vrh, vrl, vih, vil = _views(planes, n, desc)
    x0r, x1r = (vrh[idx0].clone(), vrl[idx0].clone()), \
        (vrh[idx1].clone(), vrl[idx1].clone())
    x0i = x1i = None
    if vih is not None:
        x0i, x1i = (vih[idx0].clone(), vil[idx0].clone()), \
            (vih[idx1].clone(), vil[idx1].clone())
    for row, dst in ((0, idx0), (1, idx1)):
        u, v = c[row][0], c[row][1]
        if real:
            y_re = df_add(df_mul(u[0], x0r), df_mul(v[0], x1r))
            y_im = None if x0i is None else \
                df_add(df_mul(u[0], x0i), df_mul(v[0], x1i))
        else:
            a_re, a_im = _cmul(u, x0r, x0i)
            b_re, b_im = _cmul(v, x1r, x1i)
            y_re, y_im = df_add(a_re, b_re), df_add(a_im, b_im)
        vrh[dst], vrl[dst] = y_re
        if y_im is not None:
            vih[dst], vil[dst] = y_im


def _ref_diag(planes, n, a, b, c, real):
    """Multiply each amplitude by ``c[bit_a][bit_b]`` (complex), in
    place."""
    desc = sorted({a, b}, reverse=True)
    vrh, vrl, vih, vil = _views(planes, n, desc)
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    for ba in (0, 1):
        for bb in (0, 1):
            if a == b and ba != bb:
                continue
            idx = [slice(None)] * (2 * len(desc) + 1)
            idx[axis[a]] = ba
            idx[axis[b]] = bb
            idx = tuple(idx)
            d = c[ba][bb]
            xr = (vrh[idx].clone(), vrl[idx].clone())
            xi = None if vih is None else (vih[idx].clone(),
                                           vil[idx].clone())
            if real:
                yr = df_mul(xr, d[0])
                yi = None if xi is None else df_mul(xi, d[0])
            else:
                yr, yi = _cmul(d, xr, xi)
            vrh[idx], vrl[idx] = yr
            if yi is not None:
                vih[idx], vil[idx] = yi
