"""Share of the pairs' valid keypoints still in attention, over the layers
each pair ran: the program's counters (`LightGlue.stats`: each pair's
points at each layer it ran, against its valid keypoints), over the traced
window's chunks after the profiled ones. 100 without pruning."""


def read(t):
    return t.work.get("kept_points_pct")
