"""Mean span of the readout, ``Circuit.expval`` or ``Circuit.sample`` on
the handle ``run`` returned (ops/pairsim.py, parallel/sharded.py), in
ms."""


def read(rec):
    spans = rec.spans.get("readout")
    return 1e3 * sum(spans) / len(spans) if spans else None
