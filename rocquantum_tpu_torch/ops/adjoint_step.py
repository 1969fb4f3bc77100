"""One parameterised gate's step of the adjoint sweep in one pass.

The reversible sweep (``autodiff.py``) walks a parameterised gate back as

    ket    <- V ket                              (V = U^dagger)
    M_ac    = sum_r conj(bra[r, a]) ket[r, c]    (float64)
    bra    <- V bra

over the gate's m targets, on the amplitudes where every control is 1.
On CUDA float32 planes :func:`apply` does all three in one launch of the
hand-written kernel of ``csrc/adjoint_step.cu`` (built with nvcc at first
use; it replaces no TPU kernel: the JAX package leaves these products to
XLA), updating the planes in place and writing M into a float64 row on
the device. On CPU planes it runs :func:`apply_reference`, the plain-torch
version the tests and ``chip_smoke.py`` hold the kernel against, which
walks the same index geometry.

The host side: :func:`plan` (once per gate of a sweep) sorts the targets
(the kernel wants the lowest first), places them and the controls in the
kernel's 16-byte vectors of index bits 0-1 (:class:`StepPlan`), and
:func:`pack` brings every step's V of a request into the kernel's order
in one numpy call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

MAX_TARGETS = 2
SCRATCH_BLOCKS = 2048   # the kernel's grid is capped at this many blocks
SCRATCH_ENTRIES = 32    # (re, im) x 4 x 4 float64 sums a block
GEO_HEADER = 11         # csrc kGeoHeader

# kernel launches in this process (one per step on the card)
LAUNCHES = 0

_LIB = None

# the two-target basis with its two bits exchanged
_SWAP = np.array([0, 2, 1, 3])


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("adjoint_step")
        fn = lib.rocq_adjoint_step
        fn.restype = ctypes.c_int
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, i, vp, i, vp, vp]
        _LIB = lib
    return _LIB


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Where a gate's amplitudes sit in the kernel's vectors.

    ``lt``: the layout of the targets on index bits 0-1 (0: none there, 1:
    the lowest on bit 0, 2: on bit 1, 3: two targets on bits 0 and 1);
    ``swap``: the gate's two targets come highest first, so V is given in
    the sorted order and M is swapped back; ``geo``: the kernel's int64
    table ``[m, lt, swap, nh, lcmask, chigh, nvec, toff[4], hpos[nh]]``
    (controls on bits 0-1, controls above as index bits, the number of
    vectors, the index offsets of the settings of the targets above bit 1,
    and the positions of every target and control above bit 1 in the
    vector index, ascending)."""

    n: int
    m: int
    lt: int
    swap: bool
    geo: np.ndarray

    @property
    def nlow(self) -> int:
        return (0, 1, 1, 2)[self.lt]


def plan(n: int, controls: Sequence[int], targets: Sequence[int]) -> StepPlan:
    """The :class:`StepPlan` of a gate on ``targets`` (``targets[0]`` the
    low bit of the gate's matrix index) under ``controls`` in an n-qubit
    state. Raises on what the kernel cannot take."""
    controls = [int(c) for c in controls]
    targets = [int(t) for t in targets]
    m = len(targets)
    qubits = controls + targets
    if not 1 <= m <= MAX_TARGETS:
        raise ValueError(f"the adjoint step takes 1 or 2 targets, got {m}")
    if n < 2 or len(set(qubits)) != len(qubits) or \
            not all(0 <= q < n for q in qubits):
        raise ValueError(f"bad qubits for an {n}-qubit step: controls "
                         f"{controls}, targets {targets}")
    order = sorted(targets)
    low = [t for t in order if t < 2]
    lt = 0 if not low else 3 if len(low) == 2 else 1 + low[0]
    high = order[len(low):]
    toff = [sum(((s >> j) & 1) << t for j, t in enumerate(high))
            for s in range(4)]
    hpos = sorted(q - 2 for q in qubits if q >= 2)
    lcmask = sum(1 << c for c in controls if c < 2)
    chigh = sum(1 << c for c in controls if c >= 2)
    swap = m == 2 and targets[0] > targets[1]
    geo = np.array([m, lt, int(swap), len(hpos), lcmask, chigh,
                    1 << (n - 2 - len(hpos))] + toff + hpos, np.int64)
    return StepPlan(n, m, lt, swap, geo)


def pack(v: np.ndarray, swaps: np.ndarray) -> np.ndarray:
    """``(P, 2, 4, 4)`` float32, re then im: the steps' V = U^dagger,
    ``v`` ``(P, 4, 4)`` complex (a one-target V in the top-left 2 x 2, the
    rest 0), in the kernel's target order (rows and columns of the steps
    whose ``swaps`` is set exchanged)."""
    v = np.asarray(v)
    swaps = np.asarray(swaps, bool)
    v = np.where(swaps[:, None, None], v[:, _SWAP][:, :, _SWAP], v)
    return np.ascontiguousarray(np.stack([v.real, v.imag], axis=1),
                                np.float32)


def scratch(device) -> torch.Tensor:
    """The kernel's float64 scratch of block sums on ``device``; one serves
    every step of a sweep on one stream."""
    return torch.empty(SCRATCH_BLOCKS * SCRATCH_ENTRIES, dtype=torch.float64,
                       device=device)


def takes(plane: torch.Tensor) -> bool:
    """Whether the kernel takes ``plane`` (and planes like it): a CUDA
    float32 contiguous ``(2^n,)`` plane, n >= 2, 16-byte aligned."""
    return (plane.device.type == "cuda" and plane.dtype == torch.float32
            and plane.dim() == 1 and plane.is_contiguous()
            and plane.numel() >= 4 and plane.data_ptr() % 16 == 0)


def _pairs(ket, bra, v) -> Tuple[tuple, tuple]:
    """``ket`` and ``bra`` with an imaginary plane each where either has
    one or V is complex (a zero plane materialized), else both real."""
    complex_ = (ket[1] is not None or bra[1] is not None
                or bool(np.any(v[1])))
    if not complex_:
        return ket, bra
    return tuple((re, torch.zeros_like(re) if im is None else im)
                 for re, im in (ket, bra))


def apply(ket, bra, v: np.ndarray, step: StepPlan, out: torch.Tensor,
          work: torch.Tensor = None):
    """One step: ``(ket, bra)`` after ``V``, with M written into ``out``, a
    ``(2, 4, 4)`` float64 row (its ``[:, :2^m, :2^m]`` entries, target
    order as the gate gives it). ``ket``, ``bra``: ``(re, im_or_None)``
    float32 planes of ``step.n`` qubits; ``v``: the step's row of
    :func:`pack`. CUDA planes go to the kernel (updated in place; ``work``
    is its scratch, a new :func:`scratch` when not given), CPU planes to
    :func:`apply_reference`. Raises when the kernel cannot take the planes
    or its launch fails."""
    if ket[0].device.type != "cuda":
        return apply_reference(ket, bra, v, step, out)
    ket, bra = _pairs(ket, bra, v)
    planes = [p for pair in (ket, bra) for p in pair if p is not None]
    for p in planes:
        if not takes(p) or p.numel() != 1 << step.n or \
                p.device != planes[0].device:
            raise ValueError("the adjoint step kernel takes contiguous, "
                             "16-byte aligned float32 (2^n,) planes on one "
                             f"card, n = {step.n}: got {p.dtype} "
                             f"{tuple(p.shape)} {p.device}")
    if out.dtype != torch.float64 or out.device != planes[0].device or \
            out.numel() != 32 or not out.is_contiguous():
        raise ValueError("M goes to a contiguous (2, 4, 4) float64 row on "
                         f"the planes' card, got {out.dtype} "
                         f"{tuple(out.shape)} {out.device}")
    v = np.ascontiguousarray(v, np.float32)
    if v.shape != (2, 4, 4):
        raise ValueError(f"V is a (2, 4, 4) float32 row, got {v.shape}")
    if work is None:
        work = scratch(planes[0].device)
    lib = build()
    global LAUNCHES
    LAUNCHES += 1
    real = ket[1] is None
    geo = step.geo
    with torch.cuda.device(planes[0].device):
        stream = torch.cuda.current_stream(planes[0].device).cuda_stream
        err = lib.rocq_adjoint_step(
            1 if real else 2, ket[0].data_ptr(),
            None if real else ket[1].data_ptr(), bra[0].data_ptr(),
            None if real else bra[1].data_ptr(), v.ctypes.data,
            geo.ctypes.data, len(geo), work.data_ptr(),
            work.numel() // SCRATCH_ENTRIES, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"adjoint step kernel launch failed: cudaError_t "
                           f"{err} (n={step.n}, m={step.m}, lt={step.lt}, "
                           f"planes={1 if real else 2})")
    return ket, bra


def _groups(step: StepPlan, device) -> torch.Tensor:
    """``(R, 2^m)`` int64: each group's amplitude indices by target value
    in the sorted order, as the kernel's vectors hold them."""
    m, lt, nlow = step.m, step.lt, step.nlow
    _, _, _, nh, lcmask, chigh, nvec = (int(x) for x in step.geo[:7])
    toff = step.geo[7:GEO_HEADER]
    x = torch.arange(nvec, dtype=torch.int64, device=device)
    for p in (int(p) for p in step.geo[GEO_HEADER:GEO_HEADER + nh]):
        x = ((x >> p) << (p + 1)) | (x & ((1 << p) - 1))
    base = (x << 2) | chigh
    rows = []
    for gi in range(4 >> nlow):
        elem = [(gi, (gi << 1) | al, gi | (al << 1), al)[lt]
                for al in range(1 << nlow)]
        if (elem[0] & lcmask) != lcmask:
            continue
        rows.append(torch.stack(
            [base + int(toff[t >> nlow]) + elem[t & ((1 << nlow) - 1)]
             for t in range(1 << m)], dim=-1))
    return torch.cat(rows)


def _apply_v(vr, vi, xr, xi):
    """``V x`` on the columns of ``(R, 2^m)`` float32 gathers as the kernel
    computes it: for each output a chain of float32 FMAs, d by d (its re:
    V_re x_re, then -V_im x_im; its im: V_re x_im, then V_im x_re), each
    FMA rounded once (float64 holds the exact product)."""
    f64 = torch.float64
    xs = [(xr[:, j].to(f64), None if xi is None else xi[:, j].to(f64))
          for j in range(xr.shape[1])]
    yr, yi = [], []
    for c in range(xr.shape[1]):
        r = im = torch.zeros_like(xs[0][0])
        for d, (x_r, x_i) in enumerate(xs):
            r = (r + float(vr[c, d]) * x_r).float().to(f64)
            if x_i is not None:
                r = (r - float(vi[c, d]) * x_i).float().to(f64)
                im = (im + float(vr[c, d]) * x_i).float().to(f64)
                im = (im + float(vi[c, d]) * x_r).float().to(f64)
        yr.append(r)
        yi.append(im)
    out_r = torch.stack(yr, -1).float()
    return out_r, None if xi is None else torch.stack(yi, -1).float()


def apply_reference(ket, bra, v: np.ndarray, step: StepPlan,
                    out: torch.Tensor):
    """:func:`apply` in plain torch, repeating the kernel's arithmetic on
    its geometry: each group's amplitudes gathered as the kernel's vectors
    place them, V applied by the kernel's float32 FMA chains, M's products
    and sums in float64, M's target order swapped back, the planes updated
    in place."""
    ket, bra = _pairs(ket, bra, v)
    idx = _groups(step, ket[0].device)
    d = 1 << step.m
    vr, vi = np.asarray(v[0], np.float32), np.asarray(v[1], np.float32)

    def gather(pair):
        return tuple(None if p is None else p[idx] for p in pair)

    kr, ki = _apply_v(vr, vi, *gather(ket))
    yr, yi = gather(bra)
    f64 = torch.float64
    m_re = yr.to(f64).T @ kr.to(f64)
    m_im = torch.zeros_like(m_re)
    if ki is not None:
        m_re = m_re + yi.to(f64).T @ ki.to(f64)
        m_im = yr.to(f64).T @ ki.to(f64) - yi.to(f64).T @ kr.to(f64)
    mm = torch.stack([m_re, m_im])
    if step.swap:
        mm = mm[:, _SWAP][:, :, _SWAP]
    out.view(2, 4, 4)[:, :d, :d] = mm.to(out.device)
    for pair, new in ((ket, (kr, ki)), (bra, _apply_v(vr, vi, yr, yi))):
        for plane, vals in zip(pair, new):
            if plane is not None:
                plane[idx] = vals
    return ket, bra
