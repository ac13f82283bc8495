"""Host milliseconds per request in ``merge_rot_shards`` (the top-K
gathered from every rank of the ``rot`` dimension and merged), on rank
0."""


def read(t):
    spans = t.spans.get("merge", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
