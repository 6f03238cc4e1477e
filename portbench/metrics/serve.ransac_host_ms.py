"""Host ms to enqueue RANSAC-PnP in a serving call (`ransac_pnp` on the
host clock, no synchronize): the median over the traced calls."""

import statistics


def read(t):
    v = t.host.get("ransac")
    return statistics.median(v) if v else None
