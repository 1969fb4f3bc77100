"""Checkpoints and phase timers: the port's ``utils/checkpoint.py`` and
``utils/profiling.py`` against the JAX package's.

A checkpoint is the JAX package's ``.npz`` (``re``, ``im``, ``meta``):
round trips in the port are bit-exact for pair, batched and complex
states, and a checkpoint written by either package resumes in the other
bit for bit (the same float parts, read back as the same complex
amplitudes).
"""

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
import rocquantum_tpu_torch as rq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.utils import checkpoint as jax_ckpt
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch.utils import checkpoint as ckpt
from rocquantum_tpu_torch.utils.profiling import (PhaseTimer, annotate,
                                                  xla_trace)

B = 3


@pytest.fixture(autouse=True)
def restore_precision():
    old = (jax_config.get_precision(), port_config.get_precision(),
           port_config.df64_enabled(), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    port_config.set_precision("df64" if old[2] else old[1])
    jax.config.update("jax_enable_x64", old[3])


def _precision(mode):
    jax_config.set_precision("double" if mode == "df64" else mode)
    port_config.set_precision(mode)


def _gates(c, complex_gates=True):
    c.h(0)
    c.cx(0, 2)
    c.ry(0.7, 1)
    if complex_gates:
        c.rz(0.4, 2)
        c.crx(0.3, 1, 3)


def _port(n, b=1, seed=0):
    return rq.Circuit(n, rq.Simulator(seed=seed, device="cpu"), batch_size=b)


def _jax(n, b=1, seed=0):
    return rocq.Circuit(n, rocq.Simulator(seed=seed), batch_size=b)


@pytest.mark.parametrize("mode,b,complex_gates", [
    ("single", 1, False), ("single", 1, True), ("single", B, True),
    ("double", 1, True), ("double", B, True), ("df64", 1, False)])
def test_round_trip_is_bit_exact(tmp_path, mode, b, complex_gates):
    """Real carries ((re, None)), complex pairs, single-precision batches
    (complex64 (b, 2^n)) and double-precision batches (float64 pairs of
    (b, 2^n) planes) come back as they went, SWAP relabels included; the
    resumed circuit runs on."""
    _precision(mode)
    path = str(tmp_path / "ckpt.npz")
    c = _port(4, b, seed=3)
    _gates(c, complex_gates)
    c.swap(0, 3)
    if b > 1:
        c.measure(0)
    want = c.get_statevector()
    ckpt.save_circuit_checkpoint(path, c)
    meta = ckpt.load_metadata(path)
    assert meta["num_qubits"] == 4 and meta["batch_size"] == b
    c2 = _port(4, b)
    ckpt.restore_circuit_checkpoint(path, c2)
    got = c2.get_statevector()
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    c.x(1)
    c2.x(1)
    assert np.array_equal(c2.get_statevector(), c.get_statevector())


@pytest.mark.parametrize("mode,b", [("single", 1), ("single", B),
                                    ("double", 1), ("double", B)])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, mode, b):
    _precision(mode)
    path = str(tmp_path / "jax.npz")
    jc = _jax(4, b, seed=5)
    _gates(jc)
    if b > 1:
        jc.measure(1)
    jax_ckpt.save_circuit_checkpoint(path, jc)
    pc = _port(4, b)
    ckpt.restore_circuit_checkpoint(path, pc)
    assert np.array_equal(pc.get_statevector(), jc.get_statevector())


@pytest.mark.parametrize("mode,b", [("single", 1), ("single", B),
                                    ("double", 1), ("double", B)])
def test_port_checkpoint_resumes_in_jax(tmp_path, mode, b):
    _precision(mode)
    path = str(tmp_path / "port.npz")
    pc = _port(4, b, seed=5)
    _gates(pc)
    if b > 1:
        pc.measure(1)
    ckpt.save_circuit_checkpoint(path, pc)
    jc = _jax(4, b)
    jax_ckpt.restore_circuit_checkpoint(path, jc)
    assert np.array_equal(jc.get_statevector(), pc.get_statevector())


def test_state_round_trip_and_metadata(tmp_path):
    path = str(tmp_path / "state.npz")
    state = torch.tensor([0.6, 0.0, 0.0, 0.8j], dtype=torch.complex64)
    ckpt.save_state(path, state, {"tag": "test"})
    assert torch.equal(ckpt.load_state(path, device="cpu"), state)
    assert ckpt.load_metadata(path) == {"tag": "test", "shape": [4]}
    loaded = jax_ckpt.load_state(path)
    assert np.array_equal(np.asarray(loaded), state.numpy())


def test_qubit_or_batch_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_circuit_checkpoint(path, _port(2))
    with pytest.raises(ValueError, match="qubits"):
        ckpt.restore_circuit_checkpoint(path, _port(3))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_circuit_checkpoint(path, _port(2, B))


def test_phase_timer_records_phases(tmp_path):
    timer = PhaseTimer(device="cpu")
    for name in ("a", "a", "b"):
        with timer.phase(name):
            pass
    s = timer.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0 and s["a"]["mean_s"] >= 0
    timer.reset()
    assert timer.summary() == {}
    with xla_trace(str(tmp_path / "trace")):
        with timer.phase("flush"), annotate("flush"):
            c = _port(3)
            c.h(0)
            c.flush()
    assert timer.summary()["flush"]["count"] == 1
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"flush"' in trace
