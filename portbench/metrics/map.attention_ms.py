"""Device ms a mapping chunk spends in softmax attention: the summed
device ranges of the port's `attention.softmax` spans (36 a chunk of
SuperGlue: 9 layers, self and cross, 2 images), over the profiled
chunks."""


def read(t):
    return t.range_ms("attention.softmax", device=True)
