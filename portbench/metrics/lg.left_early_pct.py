"""Share of the pairs that left their chunk's group while others of it
went on (each at its own stop layer): the program's counter
(`LightGlue.stats["left_early"]`), over the pairs that ran a layer in the
traced window's chunks after the profiled ones. 0 where every pair of a
group stops at the same layer."""


def read(t):
    return t.work.get("left_early_pct")
