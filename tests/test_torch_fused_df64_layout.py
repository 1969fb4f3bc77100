"""The df64 fused kernel's launches (rocquantum_tpu_torch.ops.fused_df64,
``pass_schedule`` and ``launch_params``), executed on the CPU.

The CUDA kernel cannot run here, so this file runs what it is given: an
emulator reads the packed parameter block of each launch exactly as
``csrc/fused_df64.cu`` does (tiles, register and thread bits, layouts,
exchanges through the swizzled shared-memory words, bit sources, hi/lo
records) and applies each record with ``ops/df64.py``'s ``df_add`` and
``df_mul`` on float32 tensors. Its result must equal, bit for bit, the
plain version ``apply_fused_layer_df64_reference`` applied over the specs
in the schedule's own order, and lie within 1e-13 of the plain version in
list order (the scheduler may run gates on disjoint qubits in another
order, which moves the last bits). ``test_torch_df64.py`` holds the plain
version against the JAX package's Pallas df64 kernels in interpret mode.
Specs put targets, controls and diagonal bits in every bit class of the
load layout (register, lane, warp, pair) and outside the local set (free).
"""

import numpy as np
import pytest
import torch

from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.compiler.passes import PallasBlock
from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir, qft_ir
from rocquantum_tpu_torch.ops import df64, fused_df64, fused_sv

ATOL = 1e-13
KINDS = fused_sv._KIND_CODES


@pytest.fixture(autouse=True)
def one_thread():
    """States of 2^15-2^20 amplitudes: one torch thread (more only contend
    with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    t, w = int(params["tile_bits"]), int(params["w"])
    base = np.arange(1 << (n - t), dtype=np.int64) << w
    for q in params["lbits"][w:t].astype(np.int64):
        base = ((base >> q) << (q + 1)) | (base & ((1 << q) - 1))
    return base


def _global(n, params, layout, base):
    local = _indices(params, layout)
    g = np.zeros_like(local)
    for p, q in enumerate(params["lbits"][:int(params["tile_bits"])]):
        g |= _bit(local, p) << int(q)
    return base[:, None, None] | g[None]


def _words(local, t, flips):
    """Shared-memory word of each local index: the kernel's swizzle, with
    the bank flips ``flips[p - 5]`` read from the exchange's record."""
    word = np.zeros_like(local)
    for p in range(t):
        unit = 1 << p if p < 5 else (1 << p) ^ int(flips[p - 5])
        word ^= np.where(_bit(local, p) == 1, unit, 0)
    return word


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


def _coef(m, e, part):
    """Entry e of a record as a df pair of Python floats (float32
    values)."""
    return float(m[4 * e + 2 * part]), float(m[4 * e + 2 * part + 1])


def _cmul(u, x_re, x_im):
    ur, ui = u
    return (df64.df_add(df64.df_mul(ur, x_re),
                        df64.df_neg(df64.df_mul(ui, x_im))),
            df64.df_add(df64.df_mul(ur, x_im), df64.df_mul(ui, x_re)))


def _where(on, y, x):
    return torch.where(on, y[0], x[0]), torch.where(on, y[1], x[1])


def emulate_launch(planes, n, params):
    """One kernel launch on float32 df64 planes (flat tensors), in
    place."""
    t, R = int(params["tile_bits"]), int(params["reg_bits"])
    cplx_carry = planes[2] is not None
    base = _bases(n, params)
    tid = np.arange(1 << (t - R), dtype=np.int64)
    reg = np.arange(1 << R, dtype=np.int64)
    g = torch.from_numpy(_global(n, params, 0, base))
    a = [None if p is None else p[g] for p in planes]
    cur = 0
    for op in params["ops"][:int(params["num_ops"])]:
        kind, tt = int(op["kind"]), int(op["t"])
        m = op["m"]
        if kind == fused_sv.SWAP:
            flips = m.view(np.uint8)[:max(t - 5, 0)]
            write = torch.from_numpy(_words(_indices(params, cur), t, flips))
            read = torch.from_numpy(_words(_indices(params, tt), t, flips))
            for k, x in enumerate(a):
                if x is None:
                    continue
                shared = torch.zeros((x.shape[0], 1 << t), dtype=x.dtype)
                shared[:, write] = x
                a[k] = shared[:, read]
            cur = tt
            continue
        cplx = cplx_carry and not op["real"]
        if kind == KINDS["D2"]:
            ua, ma = _source(op["a"], base, tid)
            ub, mb = _source(op["b"], base, tid)
            e = torch.from_numpy(((ua | ((reg & ma) != 0)) << 1)
                                 | (ub | ((reg & mb) != 0)))
            table = torch.from_numpy(m.reshape(4, 4).copy())
            dr = (table[e, 0], table[e, 1])
            xr = (a[0], a[1])
            if not cplx_carry:
                a[0], a[1] = df64.df_mul(xr, dr)
                continue
            xi = (a[2], a[3])
            if cplx:
                (a[0], a[1]), (a[2], a[3]) = _cmul(
                    (dr, (table[e, 2], table[e, 3])), xr, xi)
            else:
                a[0], a[1] = df64.df_mul(xr, dr)
                a[2], a[3] = df64.df_mul(xi, dr)
            continue
        j0 = torch.from_numpy(reg[(reg >> tt) & 1 == 0])
        j1 = j0 | (1 << tt)
        on = torch.ones((1, 1, 1), dtype=torch.bool)
        if kind != KINDS["U"]:
            uni, mask = _source(op["a"], base, tid)
            on = torch.from_numpy(((j0.numpy() & mask) != 0)[None, None, :]
                                  if mask else uni != 0)
        x0 = [None if x is None else x[..., j0] for x in a]
        x1 = [None if x is None else x[..., j1] for x in a]
        if kind == KINDS["CNOT"]:
            y0, y1 = x1, x0
        elif not cplx:
            y0, y1 = [None] * 4, [None] * 4
            for hi, lo in ((0, 1), (2, 3)) if cplx_carry else ((0, 1),):
                u, v = (x0[hi], x0[lo]), (x1[hi], x1[lo])
                y0[hi], y0[lo] = df64.df_add(df64.df_mul(_coef(m, 0, 0), u),
                                             df64.df_mul(_coef(m, 1, 0), v))
                y1[hi], y1[lo] = df64.df_add(df64.df_mul(_coef(m, 2, 0), u),
                                             df64.df_mul(_coef(m, 3, 0), v))
        else:
            y0, y1 = [None] * 4, [None] * 4
            for row, y in ((0, y0), (1, y1)):
                u = (_coef(m, 2 * row, 0), _coef(m, 2 * row, 1))
                v = (_coef(m, 2 * row + 1, 0), _coef(m, 2 * row + 1, 1))
                a_re, a_im = _cmul(u, (x0[0], x0[1]), (x0[2], x0[3]))
                b_re, b_im = _cmul(v, (x1[0], x1[1]), (x1[2], x1[3]))
                y[0], y[1] = df64.df_add(a_re, b_re)
                y[2], y[3] = df64.df_add(a_im, b_im)
        for k in range(0, len(a), 2):
            if a[k] is None:
                continue
            a[k][..., j0], a[k + 1][..., j0] = _where(
                on, (y0[k], y0[k + 1]), (x0[k], x0[k + 1]))
            a[k][..., j1], a[k + 1][..., j1] = _where(
                on, (y1[k], y1[k + 1]), (x1[k], x1[k + 1]))
    g = torch.from_numpy(_global(n, params, cur, base))
    for p, x in zip(planes, a):
        if p is not None:
            p[g] = x


def emulate_pass(planes, specs, gate_mats, pair_bits, real_flags):
    """fused_df64.apply_fused_layer_df64 as the kernel would run it, on
    CPU tensors; returns new planes and the specs' execution order."""
    n, specs, _, real_flags = fused_df64._check_layer(
        planes, specs, gate_mats, pair_bits, real_flags)
    planes = [None if p is None else p.clone() for p in planes]
    order = []
    for launch in fused_df64.pass_schedule(n, specs, planes[2] is not None):
        assert launch.layouts[0].is_io and _final_layout(launch).is_io
        params = fused_df64.launch_params(n, launch, gate_mats, real_flags)
        assert params.dtype == fused_df64._PARAMS_DTYPE
        emulate_launch(planes, n, params)
        order += [op[1] for op in launch.program if op[0] != fused_sv.SWAP]
    return tuple(planes), order


def _final_layout(launch):
    swaps = [op[2] for op in launch.program if op[0] == fused_sv.SWAP]
    return launch.layouts[swaps[-1] if swaps else 0]


def check_pass(planes, specs, gm, pair_bits, flags):
    """The emulated kernel equals the plain version in the schedule's
    order bitwise, and the plain version in list order within ATOL."""
    got, order = emulate_pass(planes, specs, gm, pair_bits, flags)
    assert sorted(order) == list(range(len(specs)))
    exact = fused_df64.apply_fused_layer_df64_reference(
        *planes, [specs[i] for i in order], gm[order],
        real_flags=[flags[i] for i in order])
    listed = fused_df64.apply_fused_layer_df64_reference(
        *planes, specs, gm, real_flags=flags)
    for g, e in zip(got, exact):
        if e is not None:
            assert torch.equal(g, e)
    for g, w in zip(df64.state_to_pair_f64(got),
                    df64.state_to_pair_f64(listed)):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=ATOL)
    return got, order


def _class_bits(n, pair_bits):
    """Qubits of each bit class of the load layout."""
    free = [q for q in range(fused_df64.W_BITS, n) if q not in pair_bits]
    return {"register": [0, 1], "lane": [2, 4, 6], "warp": [7, 9],
            "pair": list(pair_bits), "free": free}, [7, 8, 9]


def _class_specs(rng, n, pair_bits):
    """Every kind with target and control (or diagonal bits) in every
    class: targets local, controls and D2 bits anywhere (window bits 7-9
    too). With no pair bits, the class "pair" is empty."""
    classes, window = _class_bits(n, pair_bits)
    local = [c for c in classes if c != "free" and classes[c]]
    anywhere = {c: q for c, q in dict(classes, window=window).items() if q}
    pick = lambda c: int(rng.choice(anywhere[c]))  # noqa: E731
    specs = []
    for tc in local:
        specs.append(("U", pick(tc)))
        for cc in anywhere:
            for kind in ("CNOT", "CU"):
                t = pick(tc)
                c = pick(cc)
                if c == t:
                    c = next(q for q in anywhere[cc] + classes["register"]
                             if q != t)
                specs.append((kind, c, t))
    for ca in anywhere:
        for cb in anywhere:
            specs.append(("D2", pick(ca), pick(cb)))
        q = pick(ca)
        specs.append(("D2", q, q))
    order = rng.permutation(len(specs))
    return [specs[i] for i in order]


def _matrices(rng, specs, real):
    mats = []
    for spec in specs:
        if spec[0] == "D2":
            m = rng.choice([-1.0, 1.0], (2, 2)) * rng.uniform(0.5, 1, (2, 2)) \
                if real else np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
        elif real:
            th = rng.normal()
            m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        else:
            m, _ = np.linalg.qr(rng.normal(size=(2, 2))
                                + 1j * rng.normal(size=(2, 2)))
        mats.append(np.asarray(m, np.complex128))
    return fused_df64.pack_gate_mats_df64(mats)


def _state(rng, n, real):
    v = rng.normal(size=(2, 1 << n))
    v /= np.linalg.norm(v)
    return df64.state_from_pair_f64(torch.from_numpy(v[0]),
                                    None if real else torch.from_numpy(v[1]))


PAIRS = {15: (11, 14), 16: (10, 13, 15), 20: (11, 17, 19)}


COMPLEX_20_SPECS = 32


@pytest.mark.parametrize("mode", ["real", "complex", "real-window"])
@pytest.mark.parametrize("n", sorted(PAIRS))
def test_schedule_matches_plain_in_every_bit_class(n, mode):
    """"real-window": a pass with no pair bits, whose tile is the window."""
    rng = np.random.default_rng(n * 5 + len(mode))
    pair_bits = () if mode.endswith("window") else PAIRS[n]
    real = mode != "complex"
    specs = _class_specs(rng, n, pair_bits)
    if n == 20 and not real:
        specs = specs[:COMPLEX_20_SPECS]  # a random third: time
    gm = _matrices(rng, specs, real)
    flags = [real] * len(specs)
    launches = fused_df64.pass_schedule(n, fused_sv._normalize_specs(specs),
                                        not real)
    assert sum(x.swaps for x in launches) > 0
    check_pass(_state(rng, n, real), specs, gm, pair_bits, flags)


def test_complex_carry_takes_real_and_complex_records():
    """Real records (the real flag) and complex ones mixed on the complex
    carry."""
    rng = np.random.default_rng(11)
    n = 16
    specs = _class_specs(rng, n, PAIRS[n])
    flags = [bool(f) for f in rng.integers(0, 2, len(specs))]
    gm = np.concatenate([_matrices(rng, [s], real=f)
                         for s, f in zip(specs, flags)])
    check_pass(_state(rng, n, False), specs, gm, PAIRS[n], flags)


def _block_passes(rng, n, ir, complex_carry):
    (block,) = [item for item in interpreter.plan_items(ir.ops, n)
                if isinstance(item, PallasBlock)]
    kinds, supports, gm, flags = interpreter.pallas_block_specs_df64(
        block, interpreter._host_params(rng.normal(size=ir.num_params)))
    plan = interpreter.kernel_plan(n, kinds, supports, fused_df64,
                                   complex_carry)
    return [(tuple((kinds[i],) + tuple(p)
                   for i, p in zip(item.gate_idx, item.positions)),
             gm[list(item.gate_idx)], item.pair_bits,
             [flags[i] for i in item.gate_idx]) for item in plan]


@pytest.mark.parametrize("n", [15, 20])
def test_ansatz_passes_match_plain(n):
    """Every pass of two ring-ansatz layers on the real carry, planned with
    the kernel's geometry (the df64 main path's structure), through the
    emulated kernel."""
    rng = np.random.default_rng(n)
    passes = _block_passes(rng, n, hardware_efficient_ansatz_ir(n, 2), False)
    state = _state(rng, n, real=True)
    swaps = 0
    for specs, g, pb, fl in passes:
        assert len(pb) <= fused_df64.MAX_PAIRS
        state, _ = check_pass(state, specs, g, pb, fl)
        swaps += sum(x.swaps for x in fused_df64.pass_schedule(
            n, fused_sv._normalize_specs(specs), False))
    assert swaps > 0


def test_qft_passes_match_plain_on_the_complex_carry():
    """The QFT's kernel block on the complex carry (D2 diagonals, window
    gates, the complex geometry), every pass through the emulated kernel."""
    rng = np.random.default_rng(3)
    n = 15
    state = _state(rng, n, real=False)
    for specs, g, pb, fl in _block_passes(rng, n, qft_ir(n), True):
        assert len(pb) <= fused_df64.MAX_PAIRS
        state, _ = check_pass(state, specs, g, pb, fl)


def test_long_pass_splits_into_launches():
    """A pass with more records than one launch holds runs as several
    launches in list order."""
    rng = np.random.default_rng(3)
    n = 15
    specs = [("U", int(q)) for q in rng.integers(0, 10, 150)]
    gm = _matrices(rng, specs, real=True)
    launches = fused_df64.pass_schedule(n, fused_sv._normalize_specs(specs),
                                        False)
    assert len(launches) > 1
    check_pass(_state(rng, n, True), specs, gm, (), [True] * len(specs))


@pytest.mark.parametrize("complex_carry", [False, True])
def test_launches_fit_the_kernel(complex_carry):
    """Every launch of the class specs has at most 2^13 amplitudes a tile,
    2^5 (real) or 2^4 (complex) a thread, at most 512 threads, 96 records
    and 8 layouts; every layout places each local position once and every
    gate targets a register bit."""
    rng = np.random.default_rng(4)
    n = 20
    for pairs in (PAIRS[n], ()):
        specs = fused_sv._normalize_specs(_class_specs(rng, n, pairs))
        for launch in fused_df64.pass_schedule(n, specs, complex_carry):
            t = launch.tile_bits
            assert t <= fused_df64.W_BITS + fused_df64.MAX_PAIRS == 13
            assert launch.reg_bits == fused_df64.reg_bits(t, complex_carry)
            assert t - launch.reg_bits <= fused_sv.LANE_BITS + 4
            assert len(launch.program) <= fused_df64.MAX_OPS
            assert len(launch.layouts) <= fused_df64.MAX_LAYOUTS
            for lay in launch.layouts:
                assert sorted(lay.reg + lay.thread) == list(range(t))
            for kind, _, tt, _, _ in launch.program:
                if kind not in (fused_sv.SWAP, KINDS["D2"]):
                    assert 0 <= tt < launch.reg_bits


def test_f32_schedules_keep_their_rule():
    """The df64 rule changes nothing of the f32 kernel's schedule: the
    default rule is the f32 one, and the df64 one differs."""
    specs = fused_sv._normalize_specs(
        [("U", q) for q in (0, 1, 7, 13, 14, 15)])
    (f32,) = fused_sv.pass_schedule(20, specs)
    assert (f32,) == fused_sv.pass_schedule(20, specs, False,
                                            fused_sv.F32_RULE)
    assert (f32.tile_bits, f32.reg_bits, f32.swaps) == (11, 6, 0)
    (df,) = fused_df64.pass_schedule(20, specs, False)
    assert (df.tile_bits, df.reg_bits) == (11, fused_df64.REG_BITS)
    assert df.swaps > 0  # one of bits 7, 13, 14, 15 starts on a warp


@pytest.mark.parametrize("bad", [
    dict(pairs=(10, 11, 12, 13)),                   # four pair bits, real
    dict(pairs=(10, 11, 12, 13), im=True),          # four, complex
    dict(pairs=(10, 11, 12), extra=(13,)),          # a target off the set
])
def test_wrapper_rejects_more_than_the_geometry(bad):
    n = 18
    rh = torch.zeros(1 << n)
    ih = torch.zeros(1 << n) if bad.get("im") else None
    specs = [("U", q) for q in bad["pairs"] + bad.get("extra", (0,))]
    with pytest.raises(ValueError):
        fused_df64.apply_fused_layer_df64(
            rh, torch.zeros_like(rh), ih, None if ih is None else ih.clone(),
            specs, np.zeros((len(specs), 2, 2, 4), np.float32),
            pair_bits=bad["pairs"], real_flags=[True] * len(specs))


def test_plan_geometry_per_carry():
    """Both carries plan with the window and 3 pair bits, the most the
    wrapper takes."""
    for complex_carry in (False, True):
        assert fused_df64.plan_geometry(26, complex_carry) == (10, 3)
        assert fused_df64.plan_geometry(12, complex_carry) == (10, 3)
    assert fused_df64.MAX_PAIRS == 3
