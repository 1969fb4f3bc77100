"""The f32 fused kernel's pass schedule (rocquantum_tpu_torch.ops.fused_sv,
``pass_schedule`` and ``launch_params``), executed in numpy.

The CUDA kernel cannot run here, so this file runs what it is given: an
emulator reads the packed parameter block of each launch exactly as
``csrc/fused_sv.cu`` does (tiles, register and thread bits, layouts,
exchanges, bit sources, folded diagonals) and must land on the plain-torch
version ``apply_fused_layer_reference``, which ``test_torch_fused_sv.py``
holds against the JAX package's Pallas kernels in interpret mode. Specs put
targets, controls and diagonal bits in every bit class of the load layout
(register, lane, warp, pair) and outside the local set (free).
"""

import numpy as np
import pytest
import torch

from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir
from rocquantum_tpu_torch.ops import fused_df64, fused_sv

ATOL = 1e-5


def _bit(x, k):
    return (x >> k) & 1


def _indices(params, layout):
    """(threads, registers) local index of every amplitude of a tile."""
    t, R = int(params["tile_bits"]), int(params["reg_bits"])
    lay = params["layouts"][layout, :t].astype(np.int64)
    tid = np.arange(1 << (t - R), dtype=np.int64)[:, None]
    reg = np.arange(1 << R, dtype=np.int64)[None, :]
    local = np.zeros((tid.size, reg.size), np.int64)
    for k in range(R):
        local |= _bit(reg, k) << lay[k]
    for k in range(t - R):
        local |= _bit(tid, k) << lay[R + k]
    return local


def _bases(n, params):
    """(element offset, tile base) of every block of the grid: block k
    owns tile k & (2^(n - t) - 1) of element k >> (n - t)."""
    t, w = int(params["tile_bits"]), int(params["w"])
    block = np.arange(int(params["batch"]) << (n - t), dtype=np.int64)
    base = (block & ((1 << (n - t)) - 1)) << w
    for q in params["lbits"][w:t].astype(np.int64):
        base = ((base >> q) << (q + 1)) | (base & ((1 << q) - 1))
    return (block >> (n - t)) << n, base


def _global(n, params, layout, bases):
    offset, base = bases
    local = _indices(params, layout)
    g = np.zeros_like(local)
    for p, q in enumerate(params["lbits"][:int(params["tile_bits"])]):
        g |= _bit(local, p) << int(q)
    return (offset + base)[:, None, None] | g[None]


def _source(s, base, tid):
    """(value constant over a thread's registers, register mask)."""
    cls, idx = int(s) >> 8, int(s) & 0xFF
    if cls == fused_sv.SRC_THREAD:
        return _bit(tid, idx)[None, :, None], 0
    if cls == fused_sv.SRC_FREE:
        return _bit(base, idx)[:, None, None], 0
    if cls == fused_sv.SRC_REG:
        return np.zeros((1, 1, 1), np.int64), 1 << idx
    return np.zeros((1, 1, 1), np.int64), 0


def emulate_launch(state, n, params, complex_mode):
    """One kernel launch on a flat complex128 numpy state of
    ``params["batch"]`` elements, in place."""
    t, R = int(params["tile_bits"]), int(params["reg_bits"])
    bases = _bases(n, params)
    base = bases[1]
    tid = np.arange(1 << (t - R), dtype=np.int64)
    reg = np.arange(1 << R, dtype=np.int64)
    g = _global(n, params, 0, bases)
    if params["gen_zero"]:
        a = np.where(g == 0, 1.0 + 0j, 0j)
    else:
        a = state[g].copy()
    cur = 0
    records = params["ops"][:int(params["num_ops"])]
    for k, op in enumerate(records):
        kind, tt = int(op["kind"]), int(op["t"])
        cplx = complex_mode and not op["real"]
        m = op["m"].astype(np.float64)
        m = m[0::2] + 1j * m[1::2] if cplx else m[0::2] + 0j
        if kind == fused_sv.U4_ROW:
            continue
        if kind == fused_sv.U4:
            # rows k..k+3; register bits t (index bit 0) and a's
            assert complex_mode and int(op["a"]) >> 8 == fused_sv.SRC_REG
            u = np.array([r["m"][0::2] + 1j * r["m"][1::2]
                          for r in records[k:k + 4]], complex)
            lo, hi = tt, int(op["a"]) & 0xFF
            assert lo < hi < R
            j0 = reg[((reg >> lo) & 1 == 0) & ((reg >> hi) & 1 == 0)]
            quad = [j0, j0 | 1 << lo, j0 | 1 << hi, j0 | 1 << lo | 1 << hi]
            x = [a[..., j].copy() for j in quad]
            for row, j in enumerate(quad):
                a[..., j] = sum(u[row, c] * x[c] for c in range(4))
            continue
        if kind == fused_sv.SWAP:
            shared = np.zeros((a.shape[0], 1 << t), complex)
            shared[:, _indices(params, cur)] = a
            a = shared[:, _indices(params, tt)]
            cur = tt
            continue
        if kind == fused_sv._KIND_CODES["D2"]:
            ua, ma = _source(op["a"], base, tid)
            ub, mb = _source(op["b"], base, tid)
            e = ((ua | ((reg & ma) != 0)) << 1) | (ub | ((reg & mb) != 0))
            a = a * m[e]
            continue
        j0 = reg[(reg >> tt) & 1 == 0]
        j1 = j0 | (1 << tt)
        on = np.ones((1, 1, 1), bool)
        if kind != fused_sv._KIND_CODES["U"]:
            uni, mask = _source(op["a"], base, tid)
            on = ((j0 & mask) != 0)[None, None, :] if mask else uni != 0
        x0, x1 = a[..., j0], a[..., j1]
        if kind == fused_sv._KIND_CODES["CNOT"]:
            y0, y1 = x1, x0
        else:
            y0, y1 = m[0] * x0 + m[1] * x1, m[2] * x0 + m[3] * x1
        a[..., j0] = np.where(on, y0, x0)
        a[..., j1] = np.where(on, y1, x1)
    state[_global(n, params, cur, bases)] = a


def emulate_pass(re, im, specs, gate_mats, pair_bits, real_flags,
                 num_qubits=None, dense_mats=None):
    """fused_sv.apply_fused_layer as the kernel would run it, on numpy:
    ``(2^n,)`` planes, or ``(b, 2^n)`` ones run as one batched launch per
    scheduled launch."""
    n = num_qubits if re is None else re.shape[-1].bit_length() - 1
    batch = 1 if re is None else re.size >> n
    specs = fused_sv._normalize_specs(specs)
    pair_bits = fused_sv._check_specs(n, specs, pair_bits,
                                      fused_sv.window_bits(n),
                                      fused_sv.max_pairs(im is not None))
    state = np.zeros(1 << n, complex) if re is None else \
        (re.astype(np.complex128) + (0 if im is None else 1j * im)).ravel()
    for k, launch in enumerate(fused_sv.pass_schedule(n, specs,
                                                      im is not None)):
        assert launch.layouts[0].is_io and _final_layout(launch).is_io
        params = fused_sv.launch_params(n, launch, gate_mats, real_flags,
                                        re is None and k == 0, batch,
                                        dense_mats)
        emulate_launch(state, n, params, complex_mode=im is not None)
    return state if re is None else state.reshape(re.shape)


def _final_layout(launch):
    swaps = [op[2] for op in launch.program if op[0] == fused_sv.SWAP]
    return launch.layouts[swaps[-1] if swaps else 0]


def _class_bits(n, pair_bits):
    """Qubits of each bit class of the load layout."""
    free = [q for q in range(fused_sv.W_BITS, n) if q not in pair_bits]
    return {"register": [0, 1], "lane": [2, 4, 6], "warp": [7, 9],
            "pair": list(pair_bits), "free": free}


def _class_specs(rng, n, pair_bits):
    """Every kind with target and control (or diagonal bits) in every
    class: targets local, controls and D2 bits anywhere."""
    classes = _class_bits(n, pair_bits)
    local = [c for c in classes if c != "free" and classes[c]]
    pick = lambda c: int(rng.choice(classes[c]))  # noqa: E731
    specs = []
    for tc in local:
        specs.append(("U", pick(tc)))
        for cc in classes:
            if not classes[cc]:
                continue
            for kind in ("CNOT", "CU"):
                t = pick(tc)
                c = pick(cc)
                if c == t:
                    c = next(q for q in classes[cc] + classes["register"]
                             if q != t)
                specs.append((kind, c, t))
    for ca in classes:
        for cb in classes:
            if classes[ca] and classes[cb]:
                specs.append(("D2", pick(ca), pick(cb)))
        if classes[ca]:
            q = pick(ca)
            specs.append(("D2", q, q))
    order = rng.permutation(len(specs))
    return [specs[i] for i in order]


def _matrices(rng, specs, real):
    mats = []
    for spec in specs:
        if spec[0] == "D2":
            m = rng.choice([-1.0, 1.0], (2, 2)) if real else \
                np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
        elif real:
            th = rng.normal()
            m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        else:
            m, _ = np.linalg.qr(rng.normal(size=(2, 2))
                                + 1j * rng.normal(size=(2, 2)))
        mats.append(m)
    m = np.asarray(mats, np.complex128)
    return np.stack([m.real, m.imag], -1).astype(np.float32)


PAIRS = {15: (11, 14), 16: (10, 13, 15), 20: (11, 17, 19)}
# the real plane's widest pass: five pair bits, 2^15 amplitudes a tile
WIDE_PAIRS = {15: (10, 11, 12, 13, 14), 16: (10, 11, 13, 14, 15),
              20: (11, 13, 15, 17, 19)}


@pytest.mark.parametrize("mode", ["real", "complex", "zero", "real-wide",
                                  "zero-wide"])
@pytest.mark.parametrize("n", sorted(PAIRS))
def test_schedule_matches_reference_in_every_bit_class(n, mode):
    rng = np.random.default_rng(n * 7 + len(mode))
    pair_bits = WIDE_PAIRS[n] if mode.endswith("wide") else PAIRS[n]
    mode = mode.split("-")[0]
    specs = _class_specs(rng, n, pair_bits)
    real = mode != "complex"
    gm = _matrices(rng, specs, real)
    flags = [real] * len(specs)
    re = im = None
    if mode != "zero":
        v = rng.normal(size=(2, 1 << n))
        v /= np.linalg.norm(v)
        re = v[0].astype(np.float32)
        im = None if real else v[1].astype(np.float32)
    got = emulate_pass(re, im, specs, gm, pair_bits, flags, num_qubits=n)
    want = fused_sv.apply_fused_layer_reference(
        None if re is None else torch.from_numpy(re),
        None if im is None else torch.from_numpy(im), specs, gm,
        real_flags=flags, num_qubits=n)
    np.testing.assert_allclose(got.real, want[0].numpy(), atol=ATOL)
    if im is not None:
        np.testing.assert_allclose(got.imag, want[1].numpy(), atol=ATOL)
    else:
        np.testing.assert_allclose(got.imag, 0.0, atol=ATOL)


@pytest.mark.parametrize("mode", ["real", "complex"])
@pytest.mark.parametrize("n", [15, 16])
def test_batched_launch_matches_reference_per_element(n, mode):
    """A batch of 3 states in one launch per scheduled launch (grid of 3 *
    2^(n - t) blocks, element offsets from the block index) lands, element
    by element, on the batched plain version, which equals the unbatched
    plain version of each element."""
    rng = np.random.default_rng(n * 11 + len(mode))
    b = 3
    specs = _class_specs(rng, n, PAIRS[n])
    real = mode == "real"
    gm = _matrices(rng, specs, real)
    flags = [real] * len(specs)
    v = rng.normal(size=(2, b, 1 << n))
    v /= np.linalg.norm(v, axis=(0, 2), keepdims=True)
    re = v[0].astype(np.float32)
    im = None if real else v[1].astype(np.float32)
    got = emulate_pass(re, im, specs, gm, PAIRS[n], flags)
    assert got.shape == (b, 1 << n)
    want = fused_sv.apply_fused_layer_reference(
        torch.from_numpy(re), None if im is None else torch.from_numpy(im),
        specs, gm, real_flags=flags)
    for k in range(b):
        one = fused_sv.apply_fused_layer_reference(
            torch.from_numpy(re[k]),
            None if im is None else torch.from_numpy(im[k]), specs, gm,
            real_flags=flags)
        for plane, row in zip(want, one):
            if plane is not None:
                assert torch.equal(plane[k], row)
        np.testing.assert_allclose(got[k].real, want[0][k].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(got[k].imag, 0.0 if real
                                   else want[1][k].numpy(), atol=ATOL)


def test_unbatched_parameter_block_only_gains_the_batch_field():
    """A b = 1 block is the block of the kernel before batching (the
    4008-byte layout without ``batch``) with the field inserted after
    ``gen_zero``: every other byte in place; b = 3 differs only there."""
    rng = np.random.default_rng(4)
    n = 16
    specs = fused_sv._normalize_specs(_class_specs(rng, n, PAIRS[n]))
    gm = _matrices(rng, specs, real=False)
    flags = [False] * len(specs)
    old_dtype = np.dtype([(name, fused_sv._PARAMS_DTYPE.fields[name][0])
                          for name in fused_sv._PARAMS_DTYPE.names
                          if name != "batch"])
    assert old_dtype.itemsize == 4008
    at = fused_sv._PARAMS_DTYPE.fields["batch"][1]
    assert at == old_dtype.fields["lbits"][1]
    for launch in fused_sv.pass_schedule(n, specs, True):
        one = fused_sv.launch_params(n, launch, gm, flags, False)
        three = fused_sv.launch_params(n, launch, gm, flags, False, 3)
        assert int(one["batch"]) == 1 and int(three["batch"]) == 3
        old = np.zeros((), old_dtype)
        for name in old_dtype.names:
            old[name] = one[name]
        raw = one.reshape(1).view(np.uint8)
        assert bytes(raw[:at]) + bytes(raw[at + 4:]) == \
            old.reshape(1).view(np.uint8).tobytes()
        diff = np.flatnonzero(raw != three.reshape(1).view(np.uint8))
        assert set(diff) <= set(range(at, at + 4))


@pytest.mark.parametrize("n", [15, 20])
def test_ansatz_passes_match_reference(n):
    """Every pass of two ring-ansatz layers (the main path's structure,
    with its many exchanges) through the emulated kernel."""
    rng = np.random.default_rng(n)
    (block,) = interpreter.plan_items(hardware_efficient_ansatz_ir(n, 2).ops,
                                      n)
    kinds, supports, gm, flags = interpreter.pallas_block_specs(
        block, interpreter._host_params(rng.normal(size=2 * n)))
    plan = interpreter.kernel_plan(n, kinds, supports)
    state = rng.normal(size=1 << n).astype(np.float32)
    state /= np.linalg.norm(state)
    want = torch.from_numpy(state)
    swaps = 0
    for item in plan:
        idx = list(item.gate_idx)
        specs = tuple((kinds[i],) + tuple(p)
                      for i, p in zip(idx, item.positions))
        fl = [flags[i] for i in idx]
        got = emulate_pass(state, None, specs, gm[idx], item.pair_bits, fl)
        want, _ = fused_sv.apply_fused_layer_reference(want, None, specs,
                                                       gm[idx], real_flags=fl)
        np.testing.assert_allclose(got.real, want.numpy(), atol=ATOL)
        state = got.real.astype(np.float32)
        swaps += sum(launch.swaps for launch in fused_sv.pass_schedule(
            n, fused_sv._normalize_specs(specs)))
    assert swaps > 0  # the window gates went through exchanges


def _banks(word_of_unit, lanes):
    """GF(2) rank of the bank bits of a warp's lanes."""
    return fused_sv._rank5([word_of_unit(p) & 31 for p in lanes])


def test_layouts_are_permutations_with_conflict_free_exchanges():
    """Every layout places each local position once; the load layout keeps
    local bits 0-1 in a float4 and 2-6 on the lanes; every exchange's
    swizzle (the bank flips in its record) is invertible and gives both
    layouts' lanes 32 distinct banks; every gate targets a register
    bit."""
    rng = np.random.default_rng(1)
    n = 20
    specs = fused_sv._normalize_specs(_class_specs(rng, n, PAIRS[n]))
    launches = fused_sv.pass_schedule(n, specs)
    seen = []
    for launch in launches:
        t = launch.tile_bits
        targets = {s[-1] for s in specs if s[0] != "D2"}
        assert launch.lbits[:fused_sv.ROW_BITS] == tuple(
            range(fused_sv.ROW_BITS))
        assert targets <= set(launch.lbits)
        assert t == max(fused_sv.MIN_TILE_BITS, fused_sv.ROW_BITS + len(
            [q for q in targets if q >= fused_sv.ROW_BITS]))
        assert launch.reg_bits in (5, fused_sv.reg_bits(t, False))
        assert len(launch.program) <= fused_sv.MAX_OPS
        assert len(launch.layouts) <= fused_sv.MAX_LAYOUTS
        for lay in launch.layouts:
            assert sorted(lay.reg + lay.thread) == list(range(t))
        params = fused_sv.launch_params(
            n, launch, np.zeros((len(specs), 2, 2, 2), np.float32),
            [True] * len(specs), False)
        cur = 0
        for r, (kind, spec, tt, a, b) in enumerate(launch.program):
            if kind == fused_sv.SWAP:
                g = params["ops"][r]["m"].view(np.uint8)[:t - 5]
                unit = lambda p: 1 << p if p < 5 else \
                    (1 << p) ^ int(g[p - 5])  # noqa: E731
                words = [0]
                for p in range(t):
                    words = words + [w ^ unit(p) for w in words]
                assert sorted(words) == list(range(1 << t))
                for lay in (launch.layouts[cur], launch.layouts[tt]):
                    assert _banks(unit, lay.thread[:fused_sv.LANE_BITS]) \
                        == fused_sv.LANE_BITS
                cur = tt
            else:
                seen.append(spec)
                if kind != fused_sv._KIND_CODES["D2"]:
                    assert 0 <= tt < launch.reg_bits
    assert sorted(seen) == list(range(len(specs)))


def test_schedule_never_reorders_dependent_gates():
    """The execution order keeps every pair of gates that share a qubit in
    list order."""
    rng = np.random.default_rng(2)
    n = 16
    specs = fused_sv._normalize_specs(_class_specs(rng, n, PAIRS[n]))
    order = [op[1] for launch in fused_sv.pass_schedule(n, specs)
             for op in launch.program if op[0] != fused_sv.SWAP]
    where = {g: k for k, g in enumerate(order)}
    for i in range(len(specs)):
        for j in range(i):
            if set(specs[i][1:]) & set(specs[j][1:]):
                assert where[j] < where[i]


def test_long_pass_splits_into_launches():
    """A pass with more records than one launch holds runs as several
    launches in list order, still equal to the reference."""
    rng = np.random.default_rng(3)
    n = 15
    specs = [("U", int(q)) for q in rng.integers(0, 10, 150)]
    gm = _matrices(rng, specs, real=True)
    flags = [True] * len(specs)
    launches = fused_sv.pass_schedule(n, fused_sv._normalize_specs(specs))
    assert len(launches) > 1
    got = emulate_pass(None, None, specs, gm, (), flags, num_qubits=n)
    want, _ = fused_sv.apply_fused_layer_reference(
        None, None, specs, gm, real_flags=flags, num_qubits=n)
    np.testing.assert_allclose(got.real, want.numpy(), atol=ATOL)


def test_pair_only_pass_needs_no_exchange():
    """A pass whose gates target only pair bits and local bits 0-1 runs
    load, registers, store: no shared memory."""
    specs = fused_sv._normalize_specs(
        [("U", 13), ("U", 14), ("CNOT", 12, 13), ("CNOT", 13, 14), ("U", 0),
         ("D2", 3, 14)])
    (launch,) = fused_sv.pass_schedule(20, specs)
    assert launch.swaps == 0 and len(launch.layouts) == 1


def test_schedule_rejects_small_states():
    with pytest.raises(ValueError):
        fused_sv.pass_schedule(fused_sv.MIN_TILE_BITS - 1, (("U", 0),))


def test_init_zero_on_cpu_is_the_plain_plane():
    before = fused_sv.ZERO_LAUNCHES
    got = fused_sv.init_zero(12, "cpu")
    assert fused_sv.ZERO_LAUNCHES == before
    assert torch.equal(got, fused_sv._zero_plane(12, "cpu"))


def _unitaries(rng, count, dim=4):
    z = rng.normal(size=(count, dim, dim)) + 1j * rng.normal(
        size=(count, dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diagonal(r, axis1=1, axis2=2)
                / np.abs(np.diagonal(r, axis1=1, axis2=2)))[:, None, :]


def _dense_specs(rng, n, pair_bits):
    """A U4 on two qubits of every pair of local bit classes (register,
    lane, warp, pair), in both orders, among every other kind in every
    class."""
    classes = _class_bits(n, pair_bits)
    local = [c for c in classes if c != "free" and classes[c]]
    specs = list(_class_specs(rng, n, pair_bits))
    for ca in local:
        for cb in local:
            a = int(rng.choice(classes[ca]))
            b = int(rng.choice([q for q in classes[cb] + classes["register"]
                                if q != a]))
            specs.append(("U4", a, b))
    order = rng.permutation(len(specs))
    return [specs[i] for i in order]


def _dense_mats(rng, specs):
    u = _unitaries(rng, len(specs))
    return np.stack([u.real, u.imag], -1).astype(np.float32)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", sorted(PAIRS))
def test_dense_two_qubit_records_match_reference(n, batch):
    """U4 records (a 4x4 on two register bits, its rows in the three
    records that follow) in every pair of bit classes, both qubit orders,
    among the other kinds: the emulated launches land on the plain
    version, batched too."""
    rng = np.random.default_rng(n * 13 + batch)
    specs = _dense_specs(rng, n, PAIRS[n])
    gm = _matrices(rng, specs, real=False)
    dm = _dense_mats(rng, specs)
    flags = [False] * len(specs)
    v = rng.normal(size=(2, batch, 1 << n))
    v /= np.linalg.norm(v, axis=(0, 2), keepdims=True)
    re, im = (v[k].astype(np.float32).reshape(
        (batch, 1 << n) if batch > 1 else (1 << n,)) for k in range(2))
    got = emulate_pass(re, im, specs, gm, PAIRS[n], flags, dense_mats=dm)
    want = fused_sv.apply_fused_layer_reference(
        torch.from_numpy(re), torch.from_numpy(im), specs, gm,
        real_flags=flags, dense_mats=dm)
    np.testing.assert_allclose(got.real, want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(got.imag, want[1].numpy(), atol=ATOL)
    records = [op for launch in fused_sv.pass_schedule(
        n, fused_sv._normalize_specs(specs), True) for op in launch.program]
    heads = [k for k, op in enumerate(records) if op[0] == fused_sv.U4]
    assert len(heads) == sum(s[0] == "U4" for s in specs)
    for k in heads:
        assert [op[0] for op in records[k + 1:k + 4]] == [fused_sv.U4_ROW] * 3
        assert records[k][2] < records[k][3] & 0xFF


def test_dense_gate_keeps_off_the_real_plane_and_df64():
    """A U4 needs re+im: the real plane refuses it, and the df64 kernel
    has no such kind."""
    rng = np.random.default_rng(5)
    specs = [("U4", 3, 12)]
    gm = np.zeros((1, 2, 2, 2), np.float32)
    dm = _dense_mats(rng, specs)
    plane = torch.zeros(1 << 15)
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(plane, None, specs, gm, pair_bits=(12,),
                                   real_flags=[True], dense_mats=dm)
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer_reference(plane, None, specs, gm,
                                             dense_mats=dm)
    with pytest.raises(ValueError):
        fused_sv._normalize_specs(specs, fused_df64.KINDS)
