"""Host milliseconds per request in ``cluster_pose_set`` (pairwise pose
RMSD and greedy NMS on the host)."""


def read(t):
    spans = t.spans.get("cluster", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
