"""The port's QEC framework (``rocquantum_tpu_torch.qec``) against the JAX
package's: the 3-qubit repetition code and the Steane [[7,1,3]] code, for
no error and every single-qubit X, Z and Y error. Both run one circuit
fragment per stabilizer and measure its ancilla mid-circuit; the syndromes
and the corrections equal the JAX package's, and the outcome probabilities
agree within 1e-6 (single precision). The syndromes are deterministic, so
the probabilities are 1. The JAX side runs op by op (``jax.disable_jit``):
the same arithmetic, without compiling one program per fragment
structure, which would take most of this file's time.
"""

import jax
import numpy as np
import pytest

import rocquantum_tpu as rocq
import rocquantum_tpu_torch as rq
from rocquantum_tpu import qec as jax_qec
from rocquantum_tpu_torch import qec

PROB_TOL = 1e-6


def _error_kernel(prepare, error, kernel):
    def body(q):
        prepare(q)
        if error is not None:
            getattr(q, error[0])(error[1])
    return kernel(body)


def _no_prep(q):
    pass


def _steane_zero(q):
    """CSS encoder of |0>_L: H on the generator pivots, CX to the rest."""
    for piv, rest in ((0, (2, 4, 6)), (1, (2, 5, 6)), (3, (4, 5, 6))):
        q.h(piv)
        for d in rest:
            q.cx(piv, d)


CODES = {
    "repetition": (3, 5, [3, 4], _no_prep, "ThreeQubitRepetitionCode",
                   "RepetitionCodeDecoder"),
    "steane": (7, 13, list(range(7, 13)), _steane_zero, "SteaneCode",
               "SteaneDecoder"),
}


def _round(pkg, sim, code, error):
    data, n, ancillas, prepare, code_cls, dec_cls = CODES[code]
    module = jax_qec if pkg is rocq else qec
    with jax.disable_jit(pkg is rocq):
        return module.QEC_Experiment(sim).run_single_round(
            getattr(module, code_cls)(), getattr(module, dec_cls)(),
            _error_kernel(prepare, error, pkg.kernel), n, ancillas)


def _cases(code):
    data = CODES[code][0]
    return [None] + [(kind, q) for kind in ("x", "z", "y")
                     for q in range(data)]


@pytest.mark.parametrize("code,error", [(c, e) for c in sorted(CODES)
                                        for e in _cases(c)],
                         ids=lambda v: str(v))
def test_syndromes_match_reference(code, error):
    want = _round(rocq, rocq.Simulator(seed=1), code, error)
    got = _round(rq, rq.Simulator(seed=1, device="cpu"), code, error)
    assert got["syndrome"] == want["syndrome"]
    assert got["correction_applied"] == want["correction_applied"]
    np.testing.assert_allclose(got["syndrome_probs"], want["syndrome_probs"],
                               atol=PROB_TOL)
    np.testing.assert_allclose(got["syndrome_probs"], 1.0, atol=PROB_TOL)
    assert sorted(got["logical_operators"]) == \
        sorted(want["logical_operators"])


def test_decoders_locate_single_errors():
    """The decoders' tables: the repetition code's syndrome names the
    flipped qubit; the Steane code's two triples read the X and the Z
    error's position in binary (Y on one qubit fires both)."""
    rep = qec.RepetitionCodeDecoder()
    assert str(rep.decode([0, 0])) == "PauliOperator(Empty)"
    for syndrome, qubit in (([1, 0], 0), ([1, 1], 1), ([0, 1], 2)):
        assert f"X{qubit}" in str(rep.decode(syndrome))
    steane = qec.SteaneDecoder()
    for q in range(7):
        bits = [((q + 1) >> j) & 1 for j in range(3)]
        assert f"X{q}" in str(steane.decode(bits + [0, 0, 0]))
        assert f"Z{q}" in str(steane.decode([0, 0, 0] + bits))
        assert f"Y{q}" in str(steane.decode(bits + bits))
    with pytest.raises(ValueError):
        steane.decode([0, 1])


def test_experiment_validates_its_inputs():
    with pytest.raises(TypeError):
        qec.QEC_Experiment("not a simulator")
    exp = qec.QEC_Experiment(rq.Simulator(device="cpu"))
    with pytest.raises(ValueError):
        exp.extract_syndrome(qec.ThreeQubitRepetitionCode(),
                             rq.kernel(_no_prep), 5, [3])
