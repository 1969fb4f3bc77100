"""The yardstick of the kernels' roofline shares: H100 peaks and the
operations and bytes of a request's fused launches.

``gate_ops`` is a frozen copy of the arithmetic in ``chip_smoke.py``
(same counts, same peaks), kept here so that no later change to the
program or its smoke test moves the benchmark's yardstick. Gates are
classified by their matrices in ``reference/gates.py``.
"""

from portbench.reference import gates as ref_gates

# H100 SXM (NVIDIA data sheet, at its 700 W limit): HBM bandwidth, and
# FP32 work in instructions, 132 SMs x 128 lanes x 1.98 GHz: half of the
# 67 TFLOP/s, which counts an FMA as two operations.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12
PLANE_BYTES = 4  # a float32 plane; a df64 amplitude is a hi and a lo plane


def gate_ops(kind, real_mat, complex_state, df):
    """FP32 instructions per amplitude of the state for one gate. An FMA
    is one instruction. In f32 a product is one instruction and a product
    added to a sum one (an FMA). In df64 a df_mul is 9 (two_prod 2, cross
    terms 3, their sum 1, quick_two_sum 3) and a df_add 20 (two two_sums
    12, two sums 2, two quick_two_sums 6). A 2x2 row is two products and a
    sum per output component, a diagonal one product; a complex product is
    two real products and a sum per component. CU acts on the half of the
    amplitudes where its control is 1."""
    if kind == "CNOT":
        return 0.0
    if df:
        mul, add = 9, 20
        row, cmul = 2 * mul + add, 2 * mul + add
        crow = 2 * cmul + add
    else:
        mul, row, cmul, crow = 1, 2, 2, 4
    if kind == "D2":
        per = mul if not complex_state else 2 * mul if real_mat else 2 * cmul
    elif not complex_state:
        per = row
    elif real_mat:
        per = 2 * row
    else:
        per = 2 * crow
    return per * (0.5 if kind == "CU" else 1.0)


def _kinds(gates):
    """``(gate_ops kind, real matrix)`` of each primitive of ``gates``:
    a flip (X, CX) moves amplitudes and computes nothing, a controlled
    matrix is CU, a diagonal one D2, any other U."""
    for name, qubits, param in gates:
        for m, _, control in ref_gates.primitives(
                name, qubits, None if param is None else 0.7):
            if ref_gates.is_flip(m):
                kind = "CNOT"
            elif control is not None:
                kind = "CU"
            else:
                kind = "D2" if ref_gates.is_diagonal(m) else "U"
            yield kind, ref_gates.is_real(m)


def circuit_instructions(n, gates, df):
    """FP32 instructions of every gate of the circuit over 2^n amplitudes,
    whatever the plan's grouping into passes. The state is complex from
    the first gate with a complex matrix on."""
    total, complex_state = 0.0, False
    for kind, real_mat in _kinds(gates):
        complex_state = complex_state or not real_mat
        total += gate_ops(kind, real_mat, complex_state, df)
    return total * (1 << n)


def launch_bytes(n, launches, fresh, planes, devices):
    """Bytes of ``launches`` fused launches over 2^n amplitudes split over
    ``devices`` cards, one launch a card a pass: each reads its ``planes``
    once and writes them once, but the ``fresh`` ones, which start from
    |0...0>, read nothing."""
    plane = (1 << n) // devices * PLANE_BYTES * planes
    return (2 * launches - fresh) * plane


def least_seconds(n, gates, df, requests, launches, fresh, planes,
                  devices):
    """(least seconds, "bytes" or "operations") of a window's fused
    launches, summed over the cards: the larger of their bytes at the HBM
    rate and the circuit's instructions, once for each of ``requests``,
    at the FP32 rate."""
    b = launch_bytes(n, launches, fresh, planes, devices) / HBM_BYTES_PER_S
    o = requests * circuit_instructions(n, gates, df) / FP32_INSTR_PER_S
    return (o, "operations") if o > b else (b, "bytes")


def state_planes(gates, df):
    """float32 planes a launch moves: the real carry one (df64: a hi and
    a lo), twice that once a gate makes the state complex."""
    real = all(real_mat for _, real_mat in _kinds(gates))
    return (1 if real else 2) * (2 if df else 1)


def kernel_share(rec, kernel, counter, df, fresh_counter=None):
    """% of its roofline that the fused kernel whose device name holds
    ``kernel`` reaches over a traced window's records: the least time of
    the launches counted in ``counter`` (those in ``fresh_counter`` start
    from |0...0>) over their device time; None where there is nothing to
    read."""
    launches = rec.counters.get(counter, 0)
    if rec.timeline is None or not launches or not rec.requests:
        return None
    busy = rec.timeline.kernel_seconds(lambda name: kernel in name)
    if busy <= 0:
        return None
    fresh = rec.counters.get(fresh_counter, 0) if fresh_counter else 0
    least, _ = least_seconds(rec.config["num_qubits"], rec.gates, df,
                             rec.requests, launches, fresh,
                             state_planes(rec.gates, df), rec.chips)
    return 100.0 * least / busy
