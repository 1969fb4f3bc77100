"""Plain PyTorch state-vector simulation: the benchmark's reference.

It imports torch, numpy and the standard library alone: nothing of the
program under test and nothing of JAX. It takes the gate list and the
angles the benchmark made and works the state and the observable out
again, gate by gate, with in-place tensor operations.

The state is a list of blocks, one per device: block ``b`` holds the
amplitudes whose top ``log2(len(devices))`` index bits equal ``b``, as a
pair of real planes ``[re, im]`` (``im`` is None while the state is
real). Every operation runs in the dtype the state was made in, so the
same code run in a lower precision is the benchmark's control.
"""

import math

import numpy as np
import torch

from portbench.reference import gates


def full_precision():
    """Keep float32 products off TF32 for the rest of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class State:
    """``n`` qubits held as ``blocks`` in one real ``dtype``."""

    def __init__(self, n, blocks, dtype):
        self.n = n
        self.blocks = blocks
        self.dtype = dtype
        self.global_bits = int(math.log2(len(blocks)))
        self.local_bits = n - self.global_bits

    def make_complex(self):
        for blk in self.blocks:
            if blk[1] is None:
                blk[1] = torch.zeros_like(blk[0])


def zero_state(n, dtype, devices):
    """|0...0> over ``devices`` (a power of two of them)."""
    g = len(devices)
    if g & (g - 1) or (1 << n) < g:
        raise ValueError(f"{g} devices cannot hold {n} qubits in blocks")
    local = n - int(math.log2(g))
    blocks = []
    for b, dev in enumerate(devices):
        re = torch.zeros(1 << local, dtype=dtype, device=dev)
        if b == 0:
            re[0] = 1
        blocks.append([re, None])
    return State(n, blocks, dtype)


def _swap(x, y):
    tmp = x.clone()
    x.copy_(y)
    y.copy_(tmp)


def _rotate(a, b, m):
    """In place on real planes: ``a, b <- m00 a + m01 b, m10 a + m11 b``
    for a real ``m``."""
    (m00, m01), (m10, m11) = m
    if m01 == 0 and m10 == 0:
        a.mul_(m00)
        b.mul_(m11)
        return
    t = a.clone()
    a.mul_(m00).add_(b, alpha=m01)
    b.mul_(m11).add_(t, alpha=m10)


def _phase(re, im, z):
    """In place: ``re + i im <- z (re + i im)``."""
    if z == 1:
        return
    t = re.clone()
    re.mul_(z.real).add_(im, alpha=-z.imag)
    im.mul_(z.real).add_(t, alpha=z.imag)


def _mix(xr, xi, yr, yi, u, v):
    """New planes of ``u x + v y`` for complex ``x``, ``y``, ``u``, ``v``."""
    return (xr * u.real - xi * u.imag + yr * v.real - yi * v.imag,
            xr * u.imag + xi * u.real + yr * v.imag + yi * v.real)


def _combine(a, b, m):
    """In place: ``a, b <- m00 a + m01 b, m10 a + m11 b`` for the plane
    pairs ``a = [ar, ai]`` and ``b`` (``ai``, ``bi`` None on a real
    state, which a complex ``m`` never meets)."""
    (m00, m01), (m10, m11) = m
    if gates.is_flip(m):
        for p, q in zip(a, b):
            if p is not None:
                _swap(p, q)
    elif gates.is_real(m):
        real = ((m00.real, m01.real), (m10.real, m11.real))
        for p, q in zip(a, b):
            if p is not None:
                _rotate(p, q, real)
    elif gates.is_diagonal(m):
        _phase(*a, m00)
        _phase(*b, m11)
    else:
        new_a = _mix(*a, *b, m00, m01)
        new_b = _mix(*a, *b, m10, m11)
        for dst, src in zip(a + b, new_a + new_b):
            dst.copy_(src)


def _part(plane, local_bits, t, c):
    """Views of ``plane`` restricted to local bit ``c`` = 1 (where ``c``
    is local): ``(bit t = 0, bit t = 1)`` where ``t`` is local, else
    ``(the whole selection, None)``."""
    bits = sorted({q for q in (t, c) if q is not None and q < local_bits},
                  reverse=True)
    v = _term_view(plane, bits, local_bits)
    idx = [slice(None)] * v.dim()
    if c is not None and c < local_bits:
        idx[2 * bits.index(c) + 1] = 1
    if t >= local_bits:
        return v[tuple(idx)], None
    k = 2 * bits.index(t) + 1
    i0, i1 = list(idx), list(idx)
    i0[k], i1[k] = 0, 1
    return v[tuple(i0)], v[tuple(i1)]


def apply(state, m, t, c=None):
    """The 2x2 matrix ``m`` (nested tuples of Python complex numbers) on
    qubit ``t``, where qubit ``c`` (if given) is 1."""
    if not gates.is_real(m):
        state.make_complex()
    L = state.local_bits
    for b0, blk0 in enumerate(state.blocks):
        if c is not None and c >= L and not b0 >> (c - L) & 1:
            continue
        if t < L:
            halves = [(None, None) if p is None else _part(p, L, t, c)
                      for p in blk0]
            _combine([h[0] for h in halves], [h[1] for h in halves], m)
            continue
        if gates.is_diagonal(m):  # a global t: a phase on each block
            z = m[1][1] if b0 >> (t - L) & 1 else m[0][0]
            own = [None if p is None else _part(p, L, t, c)[0] for p in blk0]
            if own[1] is None:
                own[0].mul_(z.real)
            else:
                _phase(*own, z)
            continue
        if b0 >> (t - L) & 1:
            continue
        blk1 = state.blocks[b0 | 1 << (t - L)]
        dev = blk0[0].device
        own = [None if p is None else _part(p, L, t, c)[0] for p in blk0]
        far = [None if p is None else _part(p, L, t, c)[0] for p in blk1]
        moved = [None if v is None else v.to(dev, copy=True) for v in far]
        _combine(own, moved, m)
        for dst, src in zip(far, moved):
            if dst is not None:
                dst.copy_(src.to(dst.device))


def simulate(n, circuit, theta, dtype, devices):
    """Run ``circuit`` (``(name, qubits, param)`` of :mod:`gates`, ``param``
    an index into ``theta`` or None) from |0...0>."""
    state = zero_state(n, dtype, devices)
    for name, qubits, param in circuit:
        angle = None if param is None else float(theta[param])
        for m, t, c in gates.primitives(name, qubits, angle):
            apply(state, m, t, c)
    return state


def _term_view(plane, qubits, local_bits):
    """``plane`` viewed with one dimension of size 2 for each of
    ``qubits`` (descending), at dims 1, 3, 5, ..."""
    shape, prev = [], local_bits
    for q in qubits:
        shape += [1 << (prev - q - 1), 2]
        prev = q
    shape.append(1 << prev)
    return plane.view(shape)


def pauli_term(state, term):
    """<psi| P |psi> for one Pauli string ``term`` (``((pauli, qubit),
    ...)``), accumulated in the state's dtype. P|x> = i^(#Y) (-1)^(|x &
    (Y|Z)|) |x ^ (X|Y)>, so the value is the real part of i^(#Y) sum_x
    s(x) psi(x) conj(psi(x ^ flips))."""
    if any(p not in "XYZ" for p, _ in term):
        raise ValueError(f"not a Pauli string: {term}")
    L = state.local_bits
    flips = {q for p, q in term if p in "XY"}
    signs = {q for p, q in term if p in "YZ"}
    ny = sum(p == "Y" for p, _ in term)
    local = sorted({q for q in flips | signs if q < L}, reverse=True)
    xdims = [2 * i + 1 for i, q in enumerate(local) if q in flips]
    rest = [d for d in range(2 * len(local) + 1) if d % 2 == 0]
    gx = sum(1 << (q - L) for q in flips if q >= L)
    gz = sum(1 << (q - L) for q in signs if q >= L)
    total = 0.0
    for b, blk in enumerate(state.blocks):
        dev = blk[0].device
        a = [None if p is None else _term_view(p, local, L) for p in blk]
        f = [None if p is None else _term_view(p.to(dev), local, L)
             for p in state.blocks[b ^ gx]]
        if xdims:
            f = [None if p is None else p.flip(xdims) for p in f]
        # even #Y: re re + im im; odd: re im' - im re'
        pairs = ([(a[0], f[0], 1), (a[1], f[1], 1)] if ny % 2 == 0
                 else [(a[0], f[1], 1), (a[1], f[0], -1)])
        acc = None
        for x, y, sgn in pairs:
            if x is None or y is None:
                continue
            s = (x * y).sum(dim=rest, dtype=state.dtype)
            s = s if sgn > 0 else -s
            acc = s if acc is None else acc + s
        if acc is None:
            continue
        for i, q in enumerate(local):
            if q in signs:
                sign = torch.tensor([1.0, -1.0], dtype=state.dtype,
                                    device=acc.device)
                shape = [1] * acc.dim()
                shape[i] = 2
                acc = acc * sign.view(shape)
        value = float(acc.sum(dtype=state.dtype))
        total += -value if bin(b & gz).count("1") % 2 else value
    return -total if ny // 2 % 2 else total


def energy(state, terms):
    """sum_k c_k <psi| P_k |psi> over ``terms`` (``(coeff, term)``)."""
    return sum(c * pauli_term(state, term) for c, term in terms)


def probabilities_at(state, index):
    """|psi(x)|^2 for the int64 numpy array ``index``, as float64."""
    L = state.local_bits
    index = np.asarray(index, np.int64)
    out = np.zeros(index.shape, np.float64)
    for b, (re, im) in enumerate(state.blocks):
        sel = (index >> L) == b
        if not sel.any():
            continue
        local = torch.as_tensor(index[sel] & ((1 << L) - 1),
                                device=re.device)
        p = re[local].double() ** 2
        if im is not None:
            p += im[local].double() ** 2
        out[sel] = p.cpu().numpy()
    return out


def power_sum(state, k):
    """sum_x |psi(x)|^(2k), accumulated in float64."""
    total = 0.0
    for re, im in state.blocks:
        p = re.double() ** 2
        if im is not None:
            p += im.double() ** 2
        total += float((p ** k).sum())
        del p
    return total


def sample(state, shots, generator):
    """``shots`` draws of x with probability |psi(x)|^2 by inverse-CDF
    search, every step in the state's dtype; int64 numpy."""
    dt = state.dtype
    probs = []
    for re, im in state.blocks:
        p = re * re
        if im is not None:
            p += im * im
        probs.append(torch.cumsum(p, 0, dtype=dt))
    dev = probs[0].device
    totals = torch.stack([c[-1].to(dev) for c in probs])
    starts = torch.cumsum(totals, 0, dtype=dt)
    u = torch.rand(shots, generator=generator, dtype=torch.float64,
                   device=dev).to(dt) * starts[-1]
    block = torch.searchsorted(starts, u, right=True).clamp_(
        max=len(probs) - 1)
    out = torch.empty(shots, dtype=torch.int64, device=dev)
    L = state.local_bits
    for b, cdf in enumerate(probs):
        sel = block == b
        if not bool(sel.any()):
            continue
        ub = (u[sel] - (starts[b - 1] if b else 0)).to(cdf.device)
        x = torch.searchsorted(cdf, ub, right=True).clamp_(
            max=cdf.numel() - 1)
        out[sel] = x.to(dev) + (b << L)
    return out.cpu().numpy()


def planes(state, start, size):
    """``(re, im)`` views of amplitudes ``[start, start + size)`` (``im``
    None on a real state); the slice lies in one block."""
    L = state.local_bits
    b, local = start >> L, start & ((1 << L) - 1)
    if local + size > 1 << L:
        raise ValueError("an amplitude slice may not cross a block")
    return tuple(None if p is None else p[local:local + size]
                 for p in state.blocks[b])
