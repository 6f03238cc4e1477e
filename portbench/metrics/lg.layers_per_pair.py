"""Layers a pair ran before it stopped (9 at most): the program's counter
(`LightGlue.stats["layers"]`), averaged over the pairs of the traced
window's chunks after the profiled ones."""


def read(t):
    return t.work.get("layers_per_pair")
