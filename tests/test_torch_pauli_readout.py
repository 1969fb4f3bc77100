"""The Pauli readout kernel's host half (``ops/pauli_readout.py``) on the
CPU: the term encoding, the sweep plan, and a plain-torch rendering of the
kernel's arithmetic from the plan's device table, held to the per-term
plain readout of ``ops/pairsim.py``; and the readout counters of the
kernel path and the plain path. The kernel itself runs in
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from rocquantum_tpu_torch.ops import pairsim, pauli_readout as pr
from rocquantum_tpu_torch.parallel import sharded
from rocquantum_tpu_torch.parallel.mesh import make_mesh
from rocquantum_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CARD_TILE_BYTES = pr.TILE_BYTES
PAULI = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
         "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1, -1])}


def random_terms(rng, n, count, chars="IXYZ", max_len=None):
    terms = []
    for _ in range(count):
        size = int(rng.integers(0, (max_len or n) + 1))
        terms.append(tuple((str(rng.choice(list(chars))),
                            int(rng.integers(n))) for _ in range(size)))
    return terms


def dense(ops, n):
    """The matrix the plain readout applies: ops first to last."""
    m = np.eye(1 << n, dtype=complex)
    for ch, q in ops:
        full = np.kron(np.kron(np.eye(1 << (n - 1 - q)), PAULI[ch]),
                       np.eye(1 << q))
        m = full @ m
    return m


@pytest.mark.parametrize("seed", range(4))
def test_encoding_is_the_applied_product(seed):
    """i^k X^a Z^b (Z first) equals the product of the string's Paulis
    applied first to last, for strings with any X or Y; an I/Z string is
    the sign of the set of its Z qubits."""
    n = 3
    rng = np.random.default_rng(seed)
    for ops in random_terms(rng, n, 40, max_len=5):
        a, b, k = pr.encode(ops)
        x = np.arange(1 << n)
        sign = (-1.0) ** np.array([bin(v & b).count("1") for v in x])
        want = np.zeros((1 << n, 1 << n), complex)
        want[x ^ a, x] = (1j ** k) * sign
        if all(ch in "IZ" for ch, _ in ops):
            zs = {q for ch, q in ops if ch == "Z"}
            assert (a, k) == (0, 0) and b == sum(1 << q for q in zs)
        else:
            np.testing.assert_allclose(dense(ops, n), want, atol=1e-12)


def _check_plan(p, n):
    R = p.T - p.k1
    low = (1 << p.k1) - 1
    placed = []
    for sw in p.sweeps:
        pivots = [v.bit_length() - 1 for v in sw.basis]
        assert len(sw.basis) == R and len(set(pivots)) == R
        assert all(v & low == 0 and v < 1 << n for v in sw.basis)
        assert sorted(pivots + sw.outer) == list(range(p.k1, n))
        assert len(sw.terms) <= pr.MAX_TERMS
        for t in sw.terms:
            rest, _ = pr._reduce(p.codes[t][0] & ~low, sw.basis)
            assert rest == 0  # the flip mask lies in the sweep's span
        placed += sw.terms
    assert sorted(placed) == sorted(p.kept)


def cap_tile(monkeypatch, tile_bits, itemsize, planes):
    """Plan tiles of at most ``2^tile_bits`` amplitudes (None: the card's
    tile), so that small states take several sweeps."""
    if tile_bits is not None:
        monkeypatch.setattr(pr, "TILE_BYTES", min(
            CARD_TILE_BYTES, itemsize * planes << tile_bits))


@pytest.mark.parametrize("tile_bits", range(10, 16))
@pytest.mark.parametrize("n", [3, 5, 9, 14, 17, 22, 26, 30])
def test_plan_puts_every_flip_mask_inside_one_sweep(n, tile_bits,
                                                    monkeypatch):
    rng = np.random.default_rng(n * 100 + tile_bits)
    terms = random_terms(rng, n, 60)
    terms += [(("X", q),) for q in range(n)]            # the TFIM's fields
    terms += [(("X", 0), ("Y", n - 1))]                 # far apart bits
    for itemsize, planes in ((4, 1), (4, 2), (8, 1), (8, 2)):
        card_T = (CARD_TILE_BYTES // (itemsize * planes)).bit_length() - 1
        cap_tile(monkeypatch, tile_bits, itemsize, planes)
        p = pr._build_plan(n, terms, itemsize, planes)
        assert p.T == min(n, tile_bits, card_T)
        _check_plan(p, n)


def test_tfim_sweeps_at_the_benchmark_sizes():
    """n = 29 on one float32 plane: 3 sweeps; on a float64 plane, and one
    shard of 2^30 complex64 amplitudes: 4."""
    def tfim(n):
        return ([(("Z", q), ("Z", (q + 1) % n)) for q in range(n)]
                + [(("X", q),) for q in range(n)])
    assert len(pr._build_plan(29, tfim(29), 4, 1).sweeps) == 3
    assert len(pr._build_plan(29, tfim(29), 8, 1).sweeps) == 4
    assert len(pr._build_plan(30, tfim(30), 4, 2).sweeps) == 4


def test_plan_splits_a_long_sum_into_sweeps_of_at_most_max_terms():
    n = 12
    terms = [(("Z", q), ("Z", r)) for q in range(n) for r in range(n)] * 3
    p = pr._build_plan(n, terms, 4, 1)
    assert len(p.sweeps) == -(-len(terms) // pr.MAX_TERMS)
    _check_plan(p, n)


def _parity(x):
    x = x.clone()
    out = torch.zeros_like(x)
    while bool((x != 0).any()):
        out ^= x & 1
        x >>= 1
    return out


def render(re, im, terms, coeffs):
    """The kernel's arithmetic in plain torch, from the plan's int64 table
    alone: tiles gathered by the row offsets and outer bits, each term by
    its local masks, its sign split into the block's, the thread-and-chunk
    part and the pattern over the register bits j (diagonal terms by their
    group w of the header); products in the planes' dtype, sums in
    float64."""
    n = re.shape[-1].bit_length() - 1
    planes = 1 if im is None else 2
    p = pr._build_plan(n, pr._key(terms), re.element_size(), planes)
    tab = torch.as_tensor(p.table)
    T, k1, chb = p.T, p.k1, p.chb
    ksign = p.ksign
    coef = torch.tensor([float(c) * s for c, s in zip(coeffs, ksign)],
                        dtype=torch.float64)
    rows = re.reshape(-1, 1 << n)
    ims = None if im is None else im.reshape(-1, 1 << n)
    total = torch.zeros(rows.shape[0], dtype=torch.float64)
    lidx = torch.arange(1 << T)
    j = (lidx >> pr.THREAD_BITS) & ((1 << chb) - 1)
    lc = lidx & ~(((1 << chb) - 1) << pr.THREAD_BITS)
    for s in range(len(p.sweeps)):
        hdr = tab[pr.SWEEP_HEADER * s:][:pr.SWEEP_HEADER]
        d = [int(v) for v in hdr[:17]]
        rowoff = tab[int(hdr[19]):][:1 << (T - k1)]
        outer = tab[int(hdr[20]):][:n - T]
        blocks = torch.arange(1 << (n - T))
        base = torch.zeros_like(blocks)
        for i, pos in enumerate(outer.tolist()):
            base |= ((blocks >> i) & 1) << pos
        idx = (base[:, None] ^ rowoff[lidx >> k1][None, :]) | \
            (lidx & ((1 << k1) - 1))[None, :]
        v0 = rows[:, idx]
        v1 = None if ims is None else ims[:, idx]
        for t in range(d[0], int(hdr[18])):
            a_l, b_l, bg, mode, jpat, ci = tab[p.term0 + 6 * t:][:6].tolist()
            if t < d[16]:
                assert a_l == 0
                w = max(v for v in range(1 << chb) if d[v] <= t < d[v + 1])
                jsign = _parity(j & w)
                prod = v0 * v0 if v1 is None else v0 * v0 + v1 * v1
            else:
                assert a_l != 0 and (jpat == 0) == (t < int(hdr[17]))
                jsign = (jpat >> j) & 1
                u0, u1 = v0[:, :, lidx ^ a_l], None
                if v1 is not None:
                    u1 = v1[:, :, lidx ^ a_l]
                if mode == 0:
                    prod = u0 * v0 if v1 is None else u0 * v0 + u1 * v1
                else:
                    prod = u0 * v1 - u1 * v0
            sign = _parity(lc & b_l) ^ jsign
            signed = torch.where(sign.bool(), -prod, prod).to(torch.float64)
            block = torch.where(_parity(base & bg).bool(), -1.0, 1.0)
            total += coef[ci] * (signed.sum(-1) * block).sum(-1)
    return total.reshape(re.shape[:-1])


def _state(rng, n, dtype, real, batch):
    shape = (batch, 1 << n) if batch else (1 << n,)
    re = torch.as_tensor(rng.normal(size=shape)).to(dtype)
    im = None if real else torch.as_tensor(rng.normal(size=shape)).to(dtype)
    norm = torch.sqrt((re.double() ** 2).sum(-1, keepdim=True) + (
        0 if im is None else (im.double() ** 2).sum(-1, keepdim=True)))
    re = (re / norm).to(dtype)
    return re, None if im is None else (im / norm).to(dtype)


CASES = [(n, dtype, real, batch, tile_bits)
         for n, tile_bits in ((4, None), (7, 5), (10, 8), (12, 9), (14, 11))
         for dtype in (torch.float32, torch.float64)
         for real in (True, False)
         for batch in (None, 3)]


@pytest.mark.parametrize("n,dtype,real,batch,tile_bits", CASES)
def test_rendering_of_the_sweeps_matches_the_plain_readout(n, dtype, real,
                                                            batch, tile_bits,
                                                            monkeypatch):
    rng = np.random.default_rng(n + 7 * real + (batch or 0))
    re, im = _state(rng, n, dtype, real, batch)
    cap_tile(monkeypatch, tile_bits, re.element_size(), 1 if real else 2)
    terms = random_terms(rng, n, 40, max_len=4)
    terms += [(), (("Z", 1), ("Z", 1)), (("X", 2), ("Y", 2), ("Z", 0)),
              (("Y", 0), ("Y", n - 1)), (("X", n - 1),)]
    terms += [(("Z", q), ("Z", (q + 1) % n)) for q in range(n)]
    coeffs = rng.normal(size=len(terms)).tolist()
    want = pairsim.expval_terms_pair(re, im, terms, coeffs)
    got = render(re, im, terms, coeffs)
    scale = float(np.abs(coeffs).sum())
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert got.shape == want.shape and got.dtype == torch.float64
    assert float((got - want).abs().max()) <= tol * scale


@pytest.fixture
def kernel_on_the_cpu(monkeypatch):
    """The kernel path on CPU planes: ``pairsim._on_card`` says yes and
    the launch is the rendering."""
    launches = []

    def launch(re, im, terms, coeffs):
        launches.append(len(terms))
        return render(re, im, terms, coeffs)

    monkeypatch.setattr(pairsim, "_on_card", lambda x: True)
    monkeypatch.setattr(pr, "expval_terms", launch)
    return launches


def _counts(fn):
    before = dict(profiling.COUNTERS)
    out = fn()
    return out, {k: profiling.COUNTERS[k] - before[k]
                 for k in ("readout_terms", "readout_kernel_terms",
                           "readout_passes")}


TFIM5 = ([(("Z", q), ("Z", (q + 1) % 5)) for q in range(5)]
         + [(("X", q),) for q in range(5)])


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_counters_count_terms_and_kernel_terms(path, request):
    launches = request.getfixturevalue("kernel_on_the_cpu") \
        if path == "kernel" else None
    re, im = _state(np.random.default_rng(1), 5, torch.float32, False, None)
    kernel = int(path == "kernel")
    calls = [(lambda: pairsim.expval_terms_pair(re, im, TFIM5,
                                                [1.0] * 10), 10),
             (lambda: pairsim.expval_pauli_string_pair(
                 re, im, [("X", 1), ("Y", 3)]), 1),
             (lambda: pairsim.expval_pauli_product_z_pair(re, im, [0, 4]), 1)]
    for fn, terms in calls:
        _, got = _counts(fn)
        assert got["readout_terms"] == terms
        assert got["readout_kernel_terms"] == kernel * terms
        # the plain path counts its plane passes; the stand-in launch none
        assert (got["readout_passes"] > 0) == (path == "plain")
    if launches is not None:
        assert launches == [10, 1, 1]


def _sharded_state(n, shards, seed):
    rng = np.random.default_rng(seed)
    re, im = _state(rng, n, torch.float32, False, None)
    psi = torch.complex(re, im)
    mesh = make_mesh(shards, devices=[CPU] * shards)
    return sharded.shard_state(psi, mesh), psi


def test_sharded_readout_sends_local_flip_terms_to_the_kernel(
        kernel_on_the_cpu):
    """On 4 virtual shards: terms with X/Y on local bits only take a
    launch a cell with the shard's phase in the coefficient; X on a global
    bit keeps the fetch and dot; the sum is the plain readout's."""
    n, shards = 8, 4
    state, psi = _sharded_state(n, shards, 4)
    terms = [(("Z", q), ("Z", (q + 1) % n)) for q in range(n)]
    terms += [(("X", q),) for q in range(n)] + [(("Y", 2), ("Z", 7))]
    coeffs = np.random.default_rng(5).normal(size=len(terms)).tolist()
    got, counts = _counts(lambda: sharded.expval_terms(state, terms, coeffs))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pairsim, "_on_card", lambda x: False)
        want = pairsim.expval_terms_pair(psi.real, psi.imag, terms, coeffs)
    local = len(terms) - 2  # X6, X7 flip the two global bits
    assert counts["readout_terms"] == len(terms)
    assert counts["readout_kernel_terms"] == local
    assert kernel_on_the_cpu == [local] * shards
    assert abs(float(got) - float(want)) <= 1e-6 * np.abs(coeffs).sum()
