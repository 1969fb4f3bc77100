"""Free gate functions recording into the active kernel context
(reference: rocq/gates.py — h/x/y/z/ry/rz/cnot; extended to the full named
set of the engine)."""

from .kernel import _KernelBuildContext


def h(target):
    _KernelBuildContext.add_gate("h", [target])


def x(target):
    _KernelBuildContext.add_gate("x", [target])


def y(target):
    _KernelBuildContext.add_gate("y", [target])


def z(target):
    _KernelBuildContext.add_gate("z", [target])


def s(target):
    _KernelBuildContext.add_gate("s", [target])


def sdg(target):
    _KernelBuildContext.add_gate("sdg", [target])


def t(target):
    _KernelBuildContext.add_gate("t", [target])


def tdg(target):
    _KernelBuildContext.add_gate("tdg", [target])


def rx(angle, target):
    _KernelBuildContext.add_gate("rx", [target], params={"theta": angle})


def ry(angle, target):
    _KernelBuildContext.add_gate("ry", [target], params={"theta": angle})


def rz(angle, target):
    _KernelBuildContext.add_gate("rz", [target], params={"phi": angle})


def cnot(control, target):
    _KernelBuildContext.add_gate("cnot", [control, target])


cx = cnot


def cz(control, target):
    _KernelBuildContext.add_gate("cz", [control, target])


def swap(q1, q2):
    _KernelBuildContext.add_gate("swap", [q1, q2])


def ccx(c1, c2, target):
    _KernelBuildContext.add_gate("ccx", [c1, c2, target])


def mcx(controls, target):
    _KernelBuildContext.add_gate("mcx", list(controls) + [target])
