"""Mean over the window's requests of the program's ``rq.run`` span
(api.CompiledProgram.run: parameters, start state, plan replay), timed by
CUDA events on the card's stream at its edges, in ms."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_span_ms(rec, {"rq.run"})
