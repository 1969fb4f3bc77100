"""Pauli-sum readout on the card: sum_k c_k <psi|P_k|psi> in a few sweeps.

The JAX package evaluates a Pauli sum as jitted jnp
(``rocquantum_tpu/ops/pairsim.py:416``), which XLA fuses; it has no Pallas
kernel here. The eager port's per-term version (``ops/pairsim.py``: 3 to 5
whole-plane torch operations a term) stays the plain version that CPU
tensors take. On CUDA tensors :func:`expval_terms` launches the
hand-written kernel of ``csrc/pauli_readout.cu`` (built with nvcc at first
use), which reads the planes once a sweep, for a whole sum.

The host plan (:func:`plan`, cached by ``(n, terms, dtype, planes)``):

* each term is ``i^k X^a Z^b`` (:func:`encode`), its value ``Re(i^k S)``
  with ``S = sum_x conj(psi(x ^ a)) (-1)^popcount(x & b) psi(x)``: ``Re S``
  or ``Im S`` by the parity of k, the sign folded into the coefficient.
  ``Im S`` is 0 on a real state and for a diagonal term (``a = 0``): such
  odd-k terms are left out of the plan;
* a sweep reads tiles of ``2^T`` amplitudes: the ``k1`` low index bits
  (128-byte rows) and the span of ``T - k1`` high vectors chosen per sweep.
  Every flip mask ``a`` lies in one sweep's span (greedy first fit over the
  masks' high parts), so each term pairs amplitudes inside one tile;
* a term's masks in tile coordinates, its sign pattern over the thread's
  register bits, and the sweeps' row offsets and outer bits go to one
  int64 table, copied to each device once.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling
from ..utils.cache import BoundedCache
from . import _build

THREAD_BITS = 8          # 256 threads a block
TILE_BYTES = 32 * 1024   # shared memory of a tile (csrc kTileBytes)
ROW_BYTES = 128          # contiguous bytes of a tile row (2^k1 amplitudes)
MAX_TERMS = 256          # terms a sweep (csrc kMaxTerms)
SWEEP_HEADER = 24
TERM_FIELDS = 6

# kernel launches in this process (one per readout on the card)
LAUNCHES = 0

_LIB = None
_PLANS = BoundedCache()
_COEFS = BoundedCache()


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("pauli_readout")
        fn = lib.rocq_pauli_readout
        fn.restype = ctypes.c_int
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, vp, vp, ll, ll, ll, ll, i, ll, i, i, i, i, vp,
                       ll, vp, vp, vp, vp]
        _LIB = lib
    return _LIB


def encode(ops: Sequence[tuple]) -> Tuple[int, int, int]:
    """``(a, b, k)`` with ``P = i^k X^a Z^b`` for a Pauli string ``[(char,
    qubit), ...]`` applied first to last, as ``pairsim`` applies it. A
    string of only I and Z signs by the set of its Z qubits, as
    ``pairsim.expval_pauli_product_z_pair`` does (a repeated Z counts
    once); any other character than I, X, Z acts as Y there and here."""
    ops = [(ch, int(q)) for ch, q in ops]
    if all(ch in ("I", "Z") for ch, _ in ops):
        b = 0
        for ch, q in ops:
            if ch == "Z":
                b |= 1 << q
        return 0, b, 0
    a = b = k = 0
    for ch, q in ops:
        if ch == "I":
            continue
        bit = 1 << q
        # Z_q X^a = (-1)^{a_q} X^a Z_q; Y_q = i X_q Z_q
        if ch == "X":
            a ^= bit
            continue
        k += 2 * ((a >> q) & 1)
        b ^= bit
        if ch != "Z":
            k += 1
            a ^= bit
    return a, b, k % 4


def geometry(n: int, itemsize: int, planes: int) -> Tuple[int, int, int]:
    """``(T, k1, CHB)``: tile bits, low bits and the log2 of the amplitudes
    a thread holds at once, for planes of ``itemsize``-byte elements."""
    T = min(n, (TILE_BYTES // (itemsize * planes)).bit_length() - 1)
    # a tile short of the plane keeps one high vector at least
    k1 = min(T - (T < n), (ROW_BYTES // itemsize).bit_length() - 1)
    chb = 3 if itemsize * planes > 8 else 4
    return T, k1, chb


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def _reduce(h: int, basis: List[int]) -> Tuple[int, int]:
    """(``h`` reduced by the basis, its coordinates): each basis vector's
    highest bit is its own (its pivot)."""
    r = 0
    for i in sorted(range(len(basis)), key=lambda i: -basis[i].bit_length()):
        if (h >> (basis[i].bit_length() - 1)) & 1:
            h ^= basis[i]
            r |= 1 << i
    return h, r


@dataclasses.dataclass
class Sweep:
    basis: List[int]              # the T - k1 high vectors, pivots distinct
    terms: List[int]              # indices into Plan.codes
    outer: List[int] = None       # bit positions the block index spreads over


@dataclasses.dataclass
class Plan:
    T: int
    k1: int
    chb: int
    codes: List[Tuple[int, int, int]]   # (a, b, k) of every term
    kept: List[int]                     # the terms the kernel evaluates
    sweeps: List[Sweep]
    table: np.ndarray                   # the int64 device table
    term0: int                          # offset of its first term record
    devices: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def ksign(self) -> np.ndarray:
        """The sign of ``Re(i^k S)`` against ``Re S`` / ``Im S`` a term."""
        return np.array([1.0 if k in (0, 3) else -1.0
                         for _, _, k in self.codes])

    def on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        t = self.devices.get(key)
        if t is None:
            t = torch.as_tensor(self.table).to(device)
            self.devices[key] = t
        return t


def _plan_sweeps(codes, kept, n, T, k1) -> List[Sweep]:
    R = T - k1
    low = (1 << k1) - 1
    sweeps: List[Sweep] = []
    for t in kept:
        h = codes[t][0] & ~low
        for sw in sweeps:
            if len(sw.terms) >= MAX_TERMS:
                continue
            r, _ = _reduce(h, sw.basis)
            if r and len(sw.basis) >= R:
                continue
            if r:
                sw.basis.append(r)
            sw.terms.append(t)
            break
        else:
            sweeps.append(Sweep([h] if h else [], [t]))
    if not sweeps:
        sweeps.append(Sweep([], []))
    for sw in sweeps:
        for j in range(k1, n):
            if len(sw.basis) >= R:
                break
            r, _ = _reduce(1 << j, sw.basis)
            if r:
                sw.basis.append(r)
        pivots = {v.bit_length() - 1 for v in sw.basis}
        sw.outer = [j for j in range(k1, n) if j not in pivots]
        assert len(sw.basis) == R and len(sw.outer) == n - T
    return sweeps


def _term_record(code, sw: Sweep, k1: int, chb: int, index: int):
    a, b, k = code
    low = (1 << k1) - 1
    rest, coords = _reduce(a & ~low, sw.basis)
    assert rest == 0, "a flip mask outside its sweep"
    a_l = (a & low) | (coords << k1)
    b_l = b & low
    for i, v in enumerate(sw.basis):
        b_l |= _parity(v & b) << (k1 + i)
    w = (b_l >> THREAD_BITS) & ((1 << chb) - 1)
    jpat = sum(_parity(j & w) << j for j in range(1 << chb))
    return [a_l, b_l, b, k & 1, jpat, index], w


def _build_plan(n, terms, itemsize, planes) -> Plan:
    T, k1, chb = geometry(n, itemsize, planes)
    codes = [encode(t) for t in terms]
    for t in terms:
        for _, q in t:
            if not 0 <= int(q) < n:
                raise ValueError(f"qubit {q} outside a {n}-qubit state")
    # Im S is 0 on a real state and for a diagonal term: odd-k terms of
    # either read 0
    kept = [i for i, (a, _, k) in enumerate(codes)
            if k % 2 == 0 or (planes == 2 and a != 0)]
    sweeps = _plan_sweeps(codes, kept, n, T, k1)
    hdrs, recs, rowoffs, outers = [], [], [], []
    term0 = SWEEP_HEADER * len(sweeps)
    tail = term0 + TERM_FIELDS * len(kept)
    for sw in sweeps:
        diag, flat, signed = [], [], []
        for t in sw.terms:
            rec, w = _term_record(codes[t], sw, k1, chb, t)
            if codes[t][0] == 0:
                diag.append((w, rec))
            elif w == 0:
                flat.append(rec)
            else:
                signed.append(rec)
        diag.sort(key=lambda x: x[0])
        start = len(recs)
        d = [start + sum(1 for w, _ in diag if w < v) for v in range(17)]
        recs += [rec for _, rec in diag] + flat + signed
        rowoff = [0]
        for v in sw.basis:
            rowoff = rowoff + [x ^ v for x in rowoff]
        hdr = d + [d[16] + len(flat), len(recs), tail, tail + len(rowoff)]
        tail += len(rowoff) + len(sw.outer)
        rowoffs.append(rowoff)
        outers.append(sw.outer)
        hdrs.append(hdr + [0] * (SWEEP_HEADER - len(hdr)))
    table = np.array(sum(hdrs, []) + sum(recs, [])
                     + sum((r + o for r, o in zip(rowoffs, outers)), []),
                     dtype=np.int64)
    assert len(table) == tail
    return Plan(T, k1, chb, codes, kept, sweeps, table, term0)


def _key(terms) -> tuple:
    return tuple(tuple((ch, int(q)) for ch, q in t) for t in terms)


def plan(n: int, terms, dtype: torch.dtype, planes: int) -> Plan:
    """The cached host plan of ``terms`` on ``planes`` planes of ``2^n``
    elements of ``dtype``."""
    terms = _key(terms)
    key = (n, terms, dtype, planes)
    p = _PLANS.get(key)
    if p is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        p = _build_plan(n, terms, itemsize, planes)
        _PLANS[key] = p
    return p


def _coefficients(p: Plan, coeffs, device) -> torch.Tensor:
    """The terms' float64 coefficients times their ``ksign``, on
    ``device`` (cached by value)."""
    coeffs = tuple(float(c) for c in coeffs)
    key = (id(p), coeffs, str(device))
    c = _COEFS.get(key)
    if c is None or c[0] is not p:
        vals = np.asarray(coeffs, np.float64) * p.ksign
        c = (p, torch.as_tensor(vals).to(device))
        _COEFS[key] = c
    return c[1]


def _num_qubits(x: torch.Tensor) -> int:
    size = x.shape[-1]
    n = size.bit_length() - 1
    if size != 1 << n:
        raise ValueError(f"the last axis must hold 2^n amplitudes, got {size}")
    return n


def _vector_copies(re: torch.Tensor, im, k1: int) -> int:
    """1 when the kernel may copy its tiles in 16-byte pieces: a
    unit-stride plane, or the ``.real`` / ``.imag`` views of one complex
    tensor (each (re, im) pair adjacent), with 16-byte aligned rows whose
    2^k1-amplitude runs hold whole pieces; 0: amplitude by amplitude."""
    size = re.element_size()
    if im is None:
        ok = re.stride(-1) == 1
        amp = size
    else:
        ok = (re.stride(-1) == im.stride(-1) == 2
              and im.data_ptr() == re.data_ptr() + size
              and re.stride()[:-1] == im.stride()[:-1])
        amp = 2 * size
    if re.dim() == 2:
        ok = ok and (re.stride(0) * size) % 16 == 0
    return int(ok and re.data_ptr() % 16 == 0 and amp << k1 >= 16)


def expval_terms(re: torch.Tensor, im, terms, coeffs) -> torch.Tensor:
    """Sum_k coeffs[k] <P_k> on CUDA planes ``re`` (and ``im``, None for a
    real state) of shape ``(2^n,)`` or ``(rows, 2^n)``, float32 or float64,
    any element and row strides (``.real`` / ``.imag`` views too), by one
    launch of the kernel: a float64 0-d tensor or ``(rows,)``. Raises when
    the kernel cannot take the planes or its launch fails."""
    if re.device.type != "cuda":
        raise ValueError("the Pauli readout kernel takes CUDA planes, got "
                         f"{re.device}")
    if re.dtype not in (torch.float32, torch.float64) or re.dim() not in (1, 2):
        raise ValueError("the Pauli readout kernel takes (2^n,) or (rows, "
                         f"2^n) float32/float64 planes, got {re.dtype} "
                         f"{tuple(re.shape)}")
    if im is not None and (im.shape != re.shape or im.dtype != re.dtype
                           or im.device != re.device):
        raise ValueError("re and im planes differ: "
                         f"{tuple(re.shape)} {re.dtype} {re.device} vs "
                         f"{tuple(im.shape)} {im.dtype} {im.device}")
    n = _num_qubits(re)
    planes = 1 if im is None else 2
    k = min(len(terms), len(coeffs))  # zip's pairs, as the plain loop
    terms, coeffs = terms[:k], coeffs[:k]
    p = plan(n, terms, re.dtype, planes)
    out_shape = re.shape[:-1]
    rows = 1 if re.dim() == 1 else re.shape[0]
    if not p.kept or rows == 0:
        return torch.zeros(out_shape, dtype=torch.float64, device=re.device)
    coef = _coefficients(p, coeffs, re.device)
    table = p.on(re.device)
    nsweeps = len(p.sweeps)
    partial = torch.empty(rows * nsweeps << (n - p.T), dtype=torch.float64,
                          device=re.device)
    out = torch.empty(rows, dtype=torch.float64, device=re.device)
    second = re if im is None else im
    vec = _vector_copies(re, im, p.k1)
    lib = build()
    global LAUNCHES
    LAUNCHES += 1
    profiling.count("readout_passes", nsweeps * planes)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = lib.rocq_pauli_readout(
            int(re.dtype == torch.float64), planes, re.data_ptr(),
            second.data_ptr(), re.stride(-1),
            re.stride(0) if re.dim() == 2 else 0, second.stride(-1),
            second.stride(0) if re.dim() == 2 else 0, vec, rows, n, p.T,
            p.k1, nsweeps, table.data_ptr(), p.term0, coef.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"Pauli readout kernel launch failed: cudaError_t "
                           f"{err} (n={n}, {re.dtype}, planes={planes}, "
                           f"rows={rows}, sweeps={nsweeps})")
    return out.reshape(out_shape)
