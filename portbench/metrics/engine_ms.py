"""Mean span of ``CompiledProgram.run(theta)`` until the state is ready
(engine: api.CompiledProgram.run -> compiler/interpreter), in ms."""


def read(rec):
    spans = rec.spans.get("engine")
    return 1e3 * sum(spans) / len(spans) if spans else None
