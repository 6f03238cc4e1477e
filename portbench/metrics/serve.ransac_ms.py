"""Device ms a serving call spends in RANSAC-PnP (CUDA events around
`ransac_pnp`): the median over the traced calls."""

import statistics


def read(t):
    v = t.spans.get("ransac")
    return statistics.median(v) if v else None
