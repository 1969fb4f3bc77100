"""Fused gate-layer pass on the f32 state vector: the counterpart of
``rocquantum_tpu/ops/pallas_sv.py``.

:func:`apply_fused_layer` applies an ordered list of gate specs to every
amplitude of a flat ``(2^n,)`` float32 state plane pair ``(re, im)`` in one
pass. On CUDA tensors it launches the hand-written kernel in
``csrc/fused_sv.cu`` (built with nvcc at first use, updated in place); on
CPU tensors it runs :func:`apply_fused_layer_reference`, the plain-torch
version the tests and ``chip_smoke.py`` hold the kernel against.

Specs, as in the JAX package: ``("U", q)`` dense 2x2 ``gate_mats[k]`` on
qubit q; ``("CNOT", c, t)``; ``("CU", c, t)`` controlled 2x2; ``("D2", a,
b)`` multiply by the packed diagonal ``gate_mats[k, bit_a, bit_b]``.
``gate_mats`` is ``(K, 2, 2, 2)`` float32 ``[k, row, col, re/im]`` (CNOT
rows are placeholders). ``im=None`` is the real-plane mode (every gate
real); ``re=None`` (with ``im=None`` and ``num_qubits``) starts the pass
from |0...0> instead of reading a state.

Kernel geometry: a pass reaches the low :data:`W_BITS` index bits plus at
most :data:`MAX_PAIRS` "pair bits" above them (2^13 amplitudes per block:
32 KiB of shared memory for a real plane, 64 KiB for re+im). A CNOT/CU
control or a D2 bit outside that set needs no pairing: the kernel reads it
from the block index. The planner (ops/relabel.py) packs gate lists into
passes that respect this (``reach = W_BITS``, ``max_pairs = MAX_PAIRS``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .statevec import exposed_view_dims, num_qubits_of

W_BITS = 10     # low, contiguous local index bits of every pass
MAX_PAIRS = 3   # extra local bits above the window, anywhere in [W_BITS, n)

_KIND_CODES = {"U": 0, "CNOT": 1, "CU": 2, "D2": 3}

# kernel launches in this process (one per pass that reached the GPU)
LAUNCHES = 0

_LIB = None


def window_bits(n: int) -> int:
    """Low local bits of a pass on an n-qubit state (the planner's reach)."""
    return min(W_BITS, n)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("fused_sv")
        fn = lib.rocq_fused_layer
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _normalize_specs(specs) -> Tuple[tuple, ...]:
    out = []
    for spec in specs:
        kind = spec[0]
        if kind not in _KIND_CODES:
            raise ValueError(f"unknown gate kind {kind!r} in {spec}")
        qs = tuple(int(q) for q in spec[1:])
        if len(qs) != (1 if kind == "U" else 2):
            raise ValueError(f"malformed spec {spec}")
        out.append((kind,) + qs)
    return tuple(out)


def _anchored(spec, w: int) -> Tuple[int, ...]:
    """Qubits of a spec that must lie in the pass's local set: a U target;
    a CNOT/CU target and its control when the control is below the window
    (a control above it may be a free, block-resolved bit); no D2 bit."""
    kind = spec[0]
    if kind == "D2":
        return ()
    if kind == "U":
        return (spec[1],)
    return (spec[2],) if spec[1] >= w else (spec[1], spec[2])


def _check_layer(re, im, specs, gate_mats, pair_bits, real_flags,
                 num_qubits):
    """Validate a call; returns (n, specs, pair_bits, real_flags)."""
    if re is None:
        if im is not None or num_qubits is None:
            raise ValueError("re=None (start from |0...0>) requires im=None "
                             "and num_qubits")
        n = int(num_qubits)
    else:
        n = num_qubits_of(re)
    specs = _normalize_specs(specs)
    if real_flags is None:
        real_flags = (False,) * len(specs)
    real_flags = tuple(bool(f) for f in real_flags)
    if len(real_flags) != len(specs):
        raise ValueError("real_flags length must match specs")
    if im is None and not all(real_flags):
        raise ValueError("real-plane mode (im=None) requires every gate "
                         "matrix to be real")
    if tuple(np.shape(gate_mats)) != (len(specs), 2, 2, 2):
        raise ValueError(f"gate_mats must have shape ({len(specs)}, 2, 2, 2)"
                         f", got {tuple(np.shape(gate_mats))}")
    w = window_bits(n)
    pair_bits = tuple(sorted({int(p) for p in pair_bits}))
    if len(pair_bits) > MAX_PAIRS:
        raise ValueError(f"at most {MAX_PAIRS} pair bits per pass, got "
                         f"{pair_bits}")
    if any(not w <= p < n for p in pair_bits):
        raise ValueError(f"pair bits {pair_bits} must lie in [{w}, {n})")
    local = set(range(w)) | set(pair_bits)
    for spec in specs:
        if any(not 0 <= q < n for q in spec[1:]):
            raise ValueError(f"qubit out of range for n={n}: {spec}")
        if spec[0] != "U" and spec[1] == spec[2] and spec[0] != "D2":
            raise ValueError(f"control equals target in {spec}")
        if any(q not in local for q in _anchored(spec, w)):
            raise ValueError(f"{spec} touches a qubit outside the pass's "
                             f"local set (bits < {w} and {pair_bits})")
    return n, specs, pair_bits, real_flags


def apply_fused_layer(re: Optional[torch.Tensor], im: Optional[torch.Tensor],
                      specs: Sequence[tuple], gate_mats,
                      pair_bits: Sequence[int] = (),
                      real_flags: Sequence[bool] = None,
                      num_qubits: int = None, device=None):
    """Apply ``specs`` to the state in one pass; returns ``(re, im)``.

    On CUDA the planes are updated in place and returned (a fresh ``re`` in
    the ``re=None`` mode, allocated on ``device``); on the CPU the plain
    reference returns new planes. Raises ``ValueError`` on specs the pass
    cannot take and ``RuntimeError`` when the launch fails."""
    n, specs, pair_bits, real_flags = _check_layer(
        re, im, specs, gate_mats, pair_bits, real_flags, num_qubits)
    if re is not None:
        device = re.device
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return apply_fused_layer_reference(re, im, specs, gate_mats,
                                           real_flags=real_flags,
                                           num_qubits=n, device=device)
    if re is not None and not specs:
        return re, im
    for name, plane in (("re", re), ("im", im)):
        if plane is None:
            continue
        if plane.dtype != torch.float32 or not plane.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if plane.device != device or plane.numel() != 1 << n:
            raise ValueError(f"{name} must be a ({1 << n},) plane on "
                             f"{device}")
    gen_zero = re is None
    if gen_zero:
        re = torch.empty(1 << n, dtype=torch.float32, device=device)
    table = _device_table(specs, gate_mats, real_flags, device)
    k = len(specs)
    addr = table.data_ptr()
    bits = (ctypes.c_int * max(len(pair_bits), 1))(*pair_bits)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = build()
    global LAUNCHES
    LAUNCHES += 1
    err = lib.rocq_fused_layer(
        re.data_ptr(), None if im is None else im.data_ptr(),
        addr, addr + 16 * k, addr + 12 * k, k, n, window_bits(n),
        len(pair_bits), bits, int(gen_zero), stream)
    if err != 0:
        raise RuntimeError(f"fused_sv kernel launch failed: cudaError_t "
                           f"{err} (n={n}, pair_bits={pair_bits}, "
                           f"{k} gates)")
    return re, im


def _device_table(specs, gate_mats, real_flags, device) -> torch.Tensor:
    """One int32 device buffer holding the spec table (K, 3), the real
    flags (K,) and the gate matrices (K, 8) as float32 bits: a single
    asynchronous copy from pinned memory per pass."""
    k = len(specs)
    buf = np.zeros(max(12 * k, 1), np.int32)
    for i, spec in enumerate(specs):
        buf[3 * i] = _KIND_CODES[spec[0]]
        buf[3 * i + 1] = spec[1]
        buf[3 * i + 2] = spec[2] if len(spec) > 2 else -1
    buf[3 * k:4 * k] = np.asarray(real_flags, np.int32)
    if isinstance(gate_mats, torch.Tensor):
        gate_mats = gate_mats.detach().cpu().numpy()
    mats = np.ascontiguousarray(gate_mats, np.float32).reshape(k * 8)
    buf[4 * k:12 * k] = mats.view(np.int32)
    host = torch.from_numpy(buf).pin_memory()
    return host.to(device, non_blocking=True)


def _zero_plane(n: int, device) -> torch.Tensor:
    plane = torch.zeros(1 << n, dtype=torch.float32, device=device)
    plane[0] = 1.0
    return plane


def apply_fused_layer_reference(re, im, specs, gate_mats, pair_bits=(),
                                real_flags=None, num_qubits=None,
                                device=None):
    """Plain-torch version of :func:`apply_fused_layer`: applies the specs
    in order to the full flat planes through strided views, with no notion
    of the kernel's local set (``pair_bits`` is accepted and ignored).
    Returns new planes; the inputs are not modified."""
    specs = _normalize_specs(specs)
    if real_flags is not None and im is None and not all(real_flags):
        raise ValueError("real-plane mode (im=None) requires every gate "
                         "matrix to be real")
    if re is None:
        if im is not None or num_qubits is None:
            raise ValueError("re=None requires im=None and num_qubits")
        re = _zero_plane(int(num_qubits),
                         device if device is not None else "cpu")
    else:
        re = re.clone()
    im = None if im is None else im.clone()
    n = num_qubits_of(re)
    if isinstance(gate_mats, torch.Tensor):
        gate_mats = gate_mats.detach().cpu().numpy()
    # coefficients as Python floats (float32 values, as the kernel reads)
    mats = np.asarray(gate_mats, np.float32).astype(np.float64).tolist()
    x_mat = [[[0.0, 0.0], [1.0, 0.0]], [[1.0, 0.0], [0.0, 0.0]]]
    for spec, m in zip(specs, mats):
        kind = spec[0]
        if kind == "D2":
            _ref_diag(re, im, n, spec[1], spec[2], m)
        elif kind == "U":
            _ref_pair(re, im, n, spec[1], None, m)
        else:
            _ref_pair(re, im, n, spec[2], spec[1],
                      x_mat if kind == "CNOT" else m)
    return re, im


def _views(re, im, n, bits_desc):
    dims = exposed_view_dims(n, bits_desc)
    return re.view(dims), None if im is None else im.view(dims)


def _ref_pair(re, im, n, target, control, m):
    """2x2 ``m`` on ``target`` where ``control`` (if any) is 1, in place."""
    bits = [target] if control is None else [target, control]
    desc = sorted(bits, reverse=True)
    v_re, v_im = _views(re, im, n, desc)
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    idx = [slice(None)] * (2 * len(desc) + 1)
    if control is not None:
        idx[axis[control]] = 1
    idx0, idx1 = list(idx), list(idx)
    idx0[axis[target]] = 0
    idx1[axis[target]] = 1
    idx0, idx1 = tuple(idx0), tuple(idx1)
    x0r, x1r = v_re[idx0].clone(), v_re[idx1].clone()
    if v_im is None:
        v_re[idx0] = m[0][0][0] * x0r + m[0][1][0] * x1r
        v_re[idx1] = m[1][0][0] * x0r + m[1][1][0] * x1r
        return
    x0i, x1i = v_im[idx0].clone(), v_im[idx1].clone()
    for row, dst in ((0, idx0), (1, idx1)):
        (ar, ai), (br, bi) = m[row]
        v_re[dst] = ar * x0r - ai * x0i + br * x1r - bi * x1i
        v_im[dst] = ar * x0i + ai * x0r + br * x1i + bi * x1r


def _ref_diag(re, im, n, a, b, m):
    """Multiply each amplitude by ``m[bit_a][bit_b]`` (complex), in place."""
    desc = sorted({a, b}, reverse=True)
    v_re, v_im = _views(re, im, n, desc)
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    for ba in (0, 1):
        for bb in (0, 1):
            if a == b and ba != bb:
                continue
            idx = [slice(None)] * (2 * len(desc) + 1)
            idx[axis[a]] = ba
            idx[axis[b]] = bb
            idx = tuple(idx)
            dr, di = m[ba][bb]
            if v_im is None:
                v_re[idx] *= dr
                continue
            xr, xi = v_re[idx].clone(), v_im[idx].clone()
            v_re[idx] = dr * xr - di * xi
            v_im[idx] = dr * xi + di * xr
