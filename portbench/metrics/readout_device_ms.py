"""Mean over the window's requests of the program's readout spans,
``rq.expval`` or ``rq.sample`` (api.Circuit readouts over ops/pairsim.py
or parallel/sharded.py), timed by CUDA events on the card's stream at
their edges, in ms."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_span_ms(rec, {"rq.expval", "rq.sample"})
