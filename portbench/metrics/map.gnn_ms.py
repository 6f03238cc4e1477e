"""Device ms a chunk of pairs spends in SuperGlue's GNN (CUDA events
around `SuperGlue.similarity`): the median over the traced chunks."""

import statistics


def read(t):
    v = t.spans.get("gnn")
    return statistics.median(v) if v else None
