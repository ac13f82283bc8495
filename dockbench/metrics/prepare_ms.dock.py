"""Host milliseconds per request in ``DockingPipeline._prepare`` (both
structures' splat and CNN) and ``_engine_parts`` (the coupled receptor
spectrum), from a ``cuda.synchronize`` before each to one after it."""


def read(t):
    spans = t.spans.get("prepare", []) + t.spans.get("engine_parts", [])
    if not spans or not t.units:
        return None
    return 1e3 * sum(spans) / len(t.units)
