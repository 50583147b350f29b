"""The device's idle share of the traced window, in %: 100 (1 - busy /
window), busy the union of the device's kernel, copy and set intervals.
Nothing to read where the trace holds no device interval."""


def read(r):
    return r.idle_percent()
