"""Host milliseconds per step in ``make_training_batch`` (sampling,
decoys, padding, the copy to the device)."""


def read(t):
    spans = t.spans.get("batch", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
