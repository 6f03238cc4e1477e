"""Share of the profiled LightGlue chunks' host time in which no kernel
ran on the card."""


def read(t):
    if not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
