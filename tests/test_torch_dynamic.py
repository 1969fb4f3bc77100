"""Dynamic circuits (mid-circuit measurement and classical control) run
shot-batched: the port's ``compiler/dynamic.py`` and its local backend
against the JAX package's (the execution tests of
tests/test_qasm_dynamic.py).

Mid-circuit outcomes come from the simulator's host draws, one per shot in
element order, chunk k of a chunked run seeded ``seed + k``, as in the JAX
package: where each shot's result is fixed by its mid-circuit draws the
histograms are equal. The final draws come from different generators
(torch's against JAX's keys): there the estimates agree within 4 sigma.
"""

import warnings

import jax
import numpy as np
import pytest

from rocquantum_tpu import config as jax_config
from rocquantum_tpu.backends.local import LocalTPUBackend
from rocquantum_tpu.compiler import dynamic as jax_dyn
from rocquantum_tpu.compiler.qasm_parser import (
    parse_qasm3_program as jax_parse)
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import core as port_core
from rocquantum_tpu_torch.backends.local import LocalBackend
from rocquantum_tpu_torch.compiler import dynamic as dyn
from rocquantum_tpu_torch.compiler.qasm_parser import parse_qasm3_program

THETA = np.pi / 3

TELEPORT_QASM = f"""
OPENQASM 3.0;
include "stdgates.inc";
// teleport RY(theta)|0> from q[0] to q[2]
gate prep(theta) a {{
    ry(theta) a;
}}
gate bellpair a, b {{
    h a;
    cx a, b;
}}
qubit[3] q;
bit[2] c;
prep({THETA}) q[0];
bellpair q[1], q[2];
cx q[0], q[1];
h q[0];
c[0] = measure q[0];
c[1] = measure q[1];
if (c[1] == 1) {{
    x q[2];
}}
if (c[0] == 1) {{
    z q[2];
}}
"""

# programs whose every shot ends in a state fixed by its mid-circuit draws
# (for, while, switch, def, register compares, negative controls)
FIXED = {
    "conditional": ("""
        OPENQASM 3.0;
        qubit[2] q;
        bit[1] c;
        h q[0];
        c[0] = measure q[0];
        if (c[0] == 1) { x q[1]; }
        """, 256, 3),
    "qasm2_register_if": ("""
        OPENQASM 2.0;
        qreg q[2]; creg c[2];
        h q[0];
        measure q[0] -> c[0];
        if (c==1) x q[1];
        measure q[1] -> c[1];
        """, 100, 8),
    "for_measure": ("""
        OPENQASM 3.0;
        qubit[3] q;
        bit[3] c;
        for int i in [0:2] {
            h q[i];
            c[i] = measure q[i];
        }
        """, 64, 3),
    "repeat_until_success": ("""
        OPENQASM 3.0;
        qubit[1] q;
        bit[1] c;
        while (c[0] == 0) {
            h q[0];
            c[0] = measure q[0];
        }
        """, 128, 11),
    "while_masks_inactive": ("""
        OPENQASM 3.0;
        qubit[2] q;
        bit[2] c;
        h q[0];
        c[0] = measure q[0];
        while (c[0] == 0) {
            x q[1];
            x q[0];
            c[0] = measure q[0];
        }
        """, 200, 4),
    "while_register_compare": ("""
        OPENQASM 2.0;
        qreg q[1];
        creg c[1];
        while (c == 0) {
            h q[0];
            measure q[0] -> c[0];
        }
        """, 64, 9),
    "switch_register": ("""
        OPENQASM 3.0;
        qubit[2] q;
        bit[2] c;
        h q[0];
        c[0] = measure q[0];
        switch (c) {
            case 1 { x q[1]; }
            default { }
        }
        c[1] = measure q[1];
        """, 64, 3),
    "switch_priority": ("""
        OPENQASM 3.0;
        qubit[2] q;
        bit[2] c;
        x q[0];
        c[0] = measure q[0];
        switch (c[0]) {
            case 1 { x q[1]; c[1] = measure q[1]; }
            case 1, 0 { }
        }
        """, 16, 0),
    "def_return": ("""
        OPENQASM 3.0;
        qubit[2] q;
        bit[1] c;
        def coin(qubit a) -> bit {
            h a;
            return measure a;
        }
        c[0] = coin(q[0]);
        if (c[0] == 1) { x q[1]; }
        """, 64, 5),
    "negctrl": ("""
        OPENQASM 3.0;
        qubit[2] q;
        bit[1] c;
        h q[0];
        c[0] = measure q[0];
        negctrl @ x q[0], q[1];
        """, 64, 2),
}


@pytest.fixture(autouse=True)
def restore_precision():
    old = (jax_config.get_precision(), port_config.get_precision(),
           jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    port_config.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


def _both(text, shots, seed, **kwargs):
    want = jax_dyn.run_dynamic(jax_parse(text), shots, seed=seed, **kwargs)
    got = dyn.run_dynamic(parse_qasm3_program(text), shots, seed=seed,
                          device="cpu", **kwargs)
    return got, want


@pytest.mark.parametrize("name", sorted(FIXED))
def test_histograms_fixed_by_mid_circuit_draws_equal(name):
    text, shots, seed = FIXED[name]
    got, want = _both(text, shots, seed)
    assert sum(got.values()) == shots
    assert got == want


def test_teleportation():
    """The shots' mid-circuit outcomes (q[0], q[1]) equal the JAX
    package's; <Z> of the teleported qubit is cos(theta) within 0.06 and
    within 4 sigma of the JAX package's estimate."""
    shots, seed = 3000, 7
    got, want = _both(TELEPORT_QASM, shots, seed, measured_qubits=[0, 1])
    assert got == want
    ez = dyn.expval_z_dynamic(parse_qasm3_program(TELEPORT_QASM), qubit=2,
                              shots=shots, seed=seed, device="cpu")
    ez_jax = jax_dyn.expval_z_dynamic(jax_parse(TELEPORT_QASM), qubit=2,
                                      shots=shots, seed=seed)
    assert abs(ez - np.cos(THETA)) < 0.06
    sigma = np.sqrt(2 * (1 - np.cos(THETA) ** 2) / shots)
    assert abs(ez - ez_jax) <= 4 * 2 * sigma


@pytest.mark.parametrize("precision", ["single", "double"])
def test_single_shot_ensembles(precision):
    """shots = 1 runs an unbatched circuit, whose state is a float pair
    (real while it stays real): the conditional and the masked-measure
    selects take it; every seed gives the JAX package's outcome."""
    jax_config.set_precision(precision)
    port_config.set_precision(precision)
    text = FIXED["qasm2_register_if"][0]
    for seed in range(6):
        got, want = _both(text, 1, seed)
        assert sum(got.values()) == 1 and set(got) <= {"00", "11"}
        assert got == want


def test_double_precision_ensemble_conditions_each_shot():
    """Under "double" a multi-shot ensemble is a float64 pair of (shots,
    2^n) planes; each shot's condition selects for that shot alone, so
    the histogram is the single-precision one (the JAX package selects
    every shot by the first shot's flag there, ROADMAP Queue 3)."""
    text, shots, seed = FIXED["conditional"]
    want = jax_dyn.run_dynamic(jax_parse(text), shots, seed=seed)
    port_config.set_precision("double")
    got = dyn.run_dynamic(parse_qasm3_program(text), shots, seed=seed,
                          device="cpu")
    assert got == want and set(got) == {"00", "11"}


def test_chunked_runs_merge_and_seed_per_chunk(monkeypatch):
    """A cap of 2^7 amplitudes makes 64-shot chunks at n = 1: the merged
    histogram is complete and equals the JAX package's, chunk k seeded
    seed + k."""
    for module in (dyn, jax_dyn):
        monkeypatch.setattr(module, "_MAX_BATCH_ELEMENTS", 1 << 7)
    text = """
    OPENQASM 3.0;
    qubit[1] q;
    bit[1] c;
    h q[0];
    c[0] = measure q[0];
    """
    got, want = _both(text, 500, 2)
    assert sum(got.values()) == 500 and got == want
    got, _ = _both(FIXED["conditional"][0].replace("qubit[2]", "qubit[1]")
                   .replace("x q[1]", "x q[0]"), 500, 2)
    assert got == {"0": 500}


def test_local_backend_runs_dynamic_qasm():
    backend = LocalBackend(shots_seed=5, device="cpu")
    job = backend.submit_job(TELEPORT_QASM, shots=1500)
    assert backend.get_job_status(job) == "completed"
    counts = backend.get_job_result(job)
    assert sum(counts.values()) == 1500
    ref = LocalTPUBackend(shots_seed=5)
    ref_counts = ref.get_job_result(ref.submit_job(TELEPORT_QASM, 1500))

    def low_bits(hist):  # the mid-circuit qubits q[1] q[0]
        out = {}
        for k, v in hist.items():
            out[k[1:]] = out.get(k[1:], 0) + v
        return out

    assert low_bits(counts) == low_bits(ref_counts)
    p0 = sum(v for k, v in counts.items() if k[0] == "0") / 1500
    assert abs(2 * p0 - 1 - np.cos(THETA)) < 0.08
    port_core.set_target("local", device="cpu")
    hist = port_core.get_active_backend().get_job_result(
        port_core.get_active_backend().submit_job(
            FIXED["conditional"][0], 64))
    assert set(hist) <= {"00", "11"} and sum(hist.values()) == 64


def test_nonconverged_while_warns():
    text = """
    OPENQASM 3.0;
    qubit[1] q;
    bit[1] c;
    x q[0];
    c[0] = measure q[0];
    while (c[0] == 1) { z q[0]; }
    """
    prog = parse_qasm3_program(text)
    prog.items[-1].max_iter = 5
    with pytest.warns(RuntimeWarning, match="did not converge") as record:
        dyn.run_dynamic(prog, shots=4, seed=0, device="cpu")
    assert str(record[0].message) == (
        "while loop stopped after max_iter=5 iterations with 4 shot(s) "
        "still active; their results did not converge")


def test_converged_while_does_not_warn():
    text = """
    OPENQASM 3.0;
    qubit[1] q;
    bit[1] c;
    x q[0];
    c[0] = measure q[0];
    while (c[0] == 1) { x q[0]; c[0] = measure q[0]; }
    """
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        counts = dyn.run_dynamic(parse_qasm3_program(text), shots=4, seed=0,
                                 device="cpu")
    assert counts == {"0": 4}
