"""The port's flat-state engine (``compiler/interpreter.py`` ``execute``,
``compile_ir``, ``default_widths``) against the JAX package's.

At N = 15 the port plans kernel blocks (PallasBlocks) and runs them
through the fused layer's wrapper, which takes its plain version on the
CPU; the JAX package runs its Pallas kernels in interpret mode. At n = 6
neither plans a block. The same IRs and parameters are carried across by
``convert``. Tolerances: complex64 within 1e-5 of max|amp|, complex128
within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.ops import statevec as jsv
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.compiler.passes import FusedBlock, PallasBlock
from rocquantum_tpu_torch.ops import fused_sv
from rocquantum_tpu_torch.ops import statevec as sv

N = 15
F32_TOL = 1e-5
F64_TOL = 1e-12


@pytest.fixture(autouse=True)
def interpret_and_restore(monkeypatch):
    """Interpret-mode Pallas for the JAX side; afterwards both packages'
    precision and JAX's x64 flag are as they were."""
    monkeypatch.setenv("ROCQ_PALLAS_INTERPRET", "1")
    jax_interp.clear_cache()
    interpreter.clear_cache()
    old = (jax_config.get_precision(), port_config.get_precision(),
           jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    port_config.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])
    jax_interp.clear_cache()
    interpreter.clear_cache()


@pytest.fixture
def layer_calls(monkeypatch):
    """Count the fused layer's wrapper calls (each planned kernel pass)."""
    calls = []
    wrapped = fused_sv.apply_fused_layer

    def counting(*args, **kwargs):
        calls.append(1)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(fused_sv, "apply_fused_layer", counting)
    return calls


def _params(ir, seed):
    return np.random.default_rng(seed).normal(size=ir.num_params).astype(
        np.float32)


def _jax_run(ir, params, state=None, **kwargs):
    fn = jax_interp.compile_ir(ir, **kwargs)
    if state is None:
        state = jsv.init_state(ir.num_qubits)
    dtype = jnp.float64 if state.dtype == jnp.complex128 else jnp.float32
    return np.asarray(fn(state, jnp.asarray(params, dtype)))


def _port_run(ir, params, state=None, **kwargs):
    fn = interpreter.compile_ir(convert.ir_from_reference(ir), **kwargs)
    if state is None:
        state = sv.init_state(ir.num_qubits, device="cpu")
    return fn(state, params).numpy()


def _close(got, ref, tol=F32_TOL):
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _planned(ir, **kwargs):
    port_ir = convert.ir_from_reference(ir)
    low, high = interpreter.default_widths(ir.num_qubits)
    return interpreter.plan_items(port_ir.ops, ir.num_qubits,
                                  low_width=kwargs.get("low_width", low),
                                  high_width=kwargs.get("high_width", high))


def _kernel_blocks(ir):
    return sum(isinstance(item, PallasBlock) for item in _planned(ir))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_circuits_at_n15(seed, layer_calls):
    ir = jax_circuits.random_circuit_ir(N, 2, seed)
    assert _kernel_blocks(ir) > 0
    got = _port_run(ir, None)
    assert layer_calls, "no kernel pass ran"
    _close(got, _jax_run(ir, np.zeros(0)))


def test_ring_ansatz_at_n15(layer_calls):
    ir = jax_circuits.hardware_efficient_ansatz_ir(N, 2)
    assert _kernel_blocks(ir) > 0
    params = _params(ir, 3)
    got = _port_run(ir, params)
    assert layer_calls
    _close(got, _jax_run(ir, params))
    assert abs(np.linalg.norm(got) - 1.0) <= 1e-5


def test_qft_at_n15_against_the_closed_form(layer_calls):
    x = 0x2A5F % (1 << N)
    ir = jax_circuits.qft_ir(N)
    assert _kernel_blocks(ir) > 0
    got = _port_run(ir, None, state=sv.basis_state(N, x, device="cpu"))
    assert layer_calls
    ref = _jax_run(ir, np.zeros(0), state=jsv.basis_state(N, x))
    _close(got, ref)
    k = np.arange(1 << N)
    closed = np.exp(2j * np.pi * ((x * k) % (1 << N)) / (1 << N)) \
        / np.sqrt(1 << N)
    assert np.max(np.abs(got - closed)) <= 2e-6


@pytest.mark.parametrize("build", ["random", "ansatz", "qft"])
def test_small_circuits_plan_no_kernel_block(build, layer_calls):
    n = 6
    ir = {"random": lambda: jax_circuits.random_circuit_ir(n, 5, 4),
          "ansatz": lambda: jax_circuits.hardware_efficient_ansatz_ir(n, 3),
          "qft": lambda: jax_circuits.qft_ir(n)}[build]()
    assert _kernel_blocks(ir) == 0
    params = _params(ir, 5)
    _close(_port_run(ir, params), _jax_run(ir, params))
    assert not layer_calls


def _double_ir(n):
    ir = jax_circuits.hardware_efficient_ansatz_ir(n, 2)
    for op in jax_circuits.random_circuit_ir(n, 2, 7).ops:
        ir.ops.append(op)
    return ir, np.random.default_rng(8).normal(size=ir.num_params)


@pytest.mark.parametrize("n", [6, 10])
def test_complex128_runs_exactly(n):
    jax_config.set_precision("double")
    port_config.set_precision("double")
    ir, params = _double_ir(n)
    state = sv.init_state(n, device="cpu")
    assert state.dtype == torch.complex128
    got = _port_run(ir, params, state=state)
    _close(got, _jax_run(ir, params, state=jsv.init_state(n)), F64_TOL)


def test_complex128_at_kernel_width_skips_the_kernel(layer_calls):
    """At N = 15 a complex128 state runs op by op, never through the f32
    kernel, and agrees with the complex64 kernel path to f32 accuracy."""
    ir, params = _double_ir(N)
    single = _port_run(ir, params)
    assert layer_calls
    layer_calls.clear()
    port_config.set_precision("double")
    double = _port_run(ir, params, state=sv.init_state(N, device="cpu"))
    assert not layer_calls, "a complex128 state reached the f32 kernel"
    _close(single, double)


@pytest.mark.parametrize("low,high", [(0, 0), (3, 0), (0, 4), (5, 5),
                                      (9, 6)])
def test_explicit_widths(low, high):
    n = 10
    ir = jax_circuits.random_circuit_ir(n, 4, 9)
    fused = [item for item in _planned(ir, low_width=low, high_width=high)
             if isinstance(item, FusedBlock)]
    if low:
        assert any(item.qubits == tuple(range(low)) for item in fused)
    got = _port_run(ir, None, low_width=low, high_width=high)
    _close(got, _jax_run(ir, np.zeros(0), low_width=low, high_width=high))


def test_default_widths_match():
    for n in (1, 5, 9, 12, 15, 18, 29):
        assert interpreter.default_widths(n) == jax_interp.default_widths(n)


def _bound_ry(n, angles):
    ir = JaxIR(n, name="ry")
    for q, a in enumerate(angles):
        ir.add("RY", [q], params=[float(a)])
        ir.add("CNOT", [(q + 1) % n], controls=[q])
    return ir


def test_baked_angles_do_not_share_a_plan():
    """Two IRs that differ only in concrete angles give different states,
    each the JAX package's; at N = 15 (kernel blocks) each the port's own
    uncached ``execute``."""
    n = 5
    first = _bound_ry(n, np.linspace(0.1, 0.9, n))
    second = _bound_ry(n, np.linspace(1.1, 1.9, n))
    a = _port_run(first, None)
    b = _port_run(second, None)
    assert np.max(np.abs(a - b)) > 0.1
    _close(a, _jax_run(first, np.zeros(0)))
    _close(b, _jax_run(second, np.zeros(0)))
    for angles in (np.linspace(0.1, 0.9, N), np.linspace(1.1, 1.9, N)):
        ir = convert.ir_from_reference(_bound_ry(N, angles))
        low, high = interpreter.default_widths(N)
        ref = interpreter.execute(sv.init_state(N, device="cpu"), ir.ops,
                                  low_width=low, high_width=high)
        got = interpreter.compile_ir(ir)(sv.init_state(N, device="cpu"))
        assert torch.equal(got, ref)


def test_compile_ir_caches_and_leaves_the_input():
    ir = convert.ir_from_reference(
        jax_circuits.hardware_efficient_ansatz_ir(5, 2))
    fn = interpreter.compile_ir(ir)
    assert interpreter.compile_ir(ir) is fn
    state = sv.init_state(5, device="cpu")
    before = state.clone()
    fn(state, np.ones(ir.num_params))
    assert torch.equal(state, before)
    with pytest.raises(ValueError):
        fn(sv.init_state(4, device="cpu"), np.ones(ir.num_params))


def test_execute_matches_compile_ir(layer_calls):
    ir = jax_circuits.random_circuit_ir(N, 2, 11)
    port_ir = convert.ir_from_reference(ir)
    state = sv.init_state(N, device="cpu")
    got = interpreter.execute(state, port_ir.ops).numpy()
    assert layer_calls
    ref = jsv.init_state(N)
    ref = np.asarray(jax.jit(lambda s: jax_interp.execute(s, ir.ops))(ref))
    _close(got, ref)


def test_execute_without_fusion_skips_the_kernel(layer_calls):
    ir = jax_circuits.random_circuit_ir(N, 1, 12)
    port_ir = convert.ir_from_reference(ir)
    got = interpreter.execute(sv.init_state(N, device="cpu"), port_ir.ops,
                              fuse=False).numpy()
    assert not layer_calls
    _close(got, _port_run(ir, None))
