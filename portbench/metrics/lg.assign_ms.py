"""Device ms a LightGlue chunk spends in its assignments and filters: the
summed device ranges of the port's `lightglue.assign` spans (one a group
of pairs that leave together), over the profiled chunks."""


def read(t):
    return t.range_ms("lightglue.assign", device=True)
