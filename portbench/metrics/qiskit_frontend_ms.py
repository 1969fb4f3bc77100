"""Host time a request inside the program's ``rq.qiskit.translate`` span
(the Qiskit backend's instruction loop: each instruction queued on the
simulator), averaged over the window's requests, in ms. None from a
program that keeps no such span.

Where ``qiskit`` is not installed, the kind runs the plugin over the
repository's API stand-ins (``tests/_stubs/qiskit``, whose ``find_bit``
and ``to_matrix`` are one-line stubs): the number is then the plugin's own
loop over the stand-ins, not Qiskit's front end."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_span_ms(rec, {"rq.qiskit.translate"})
