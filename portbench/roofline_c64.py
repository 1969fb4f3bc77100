"""The yardstick of the complex-carry share of the fused f32 kernel's
roofline (``metrics/fused_c64_roofline.py``): the FP32 instructions of a
circuit applied to re+im float32 planes, the dense two-qubit gate among
them, and the bytes of its launches. The peaks and the one-qubit gates'
counts are ``roofline.py``'s, which this file leaves as it is.

A dense 4x4 (``SU4``) takes 16 complex multiply-adds a quadruple of
amplitudes, each four FMAs on the planes: 16 instructions an amplitude.
"""

from portbench import roofline

DENSE2Q_OPS = 16  # FP32 instructions an amplitude for one SU4
# the f32 kernel's launches as the profiler names them: the pass, and the
# pass with the dense case compiled in
KERNELS = ("fused_pass_kernel", "fused_pass_dense_kernel")


def circuit_instructions(n, gates):
    """FP32 instructions of every gate over 2^n amplitudes of a complex
    carry (the flat path is complex from its first gate)."""
    dense = sum(name == "SU4" for name, *_ in gates)
    total = dense * DENSE2Q_OPS + sum(
        roofline.gate_ops(kind, real, True, False)
        for kind, real in roofline._kinds(
            [g for g in gates if g[0] != "SU4"]))
    return total * (1 << n)


def is_kernel(name):
    return any(k in name for k in KERNELS)


def share(rec):
    """% of its roofline that the fused kernel reaches over the window's
    launches (``fused_sv`` counter): the larger of their bytes (both
    planes read and written, none from |0...0>) at the HBM rate and the
    circuit's instructions once a request at the FP32 rate, over the
    launches' device time; None where there is nothing to read."""
    launches = rec.counters.get("fused_sv", 0)
    if rec.timeline is None or not launches or not rec.requests:
        return None
    busy = rec.timeline.kernel_seconds(is_kernel)
    if busy <= 0:
        return None
    n = rec.config["num_qubits"]
    least_bytes = roofline.launch_bytes(n, launches, 0, 2, rec.chips) \
        / roofline.HBM_BYTES_PER_S
    least_ops = rec.requests * circuit_instructions(n, rec.gates) \
        / roofline.FP32_INSTR_PER_S
    return 100.0 * max(least_bytes, least_ops) / busy
