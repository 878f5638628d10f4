"""1 - busy / window over the traced cubes: the share of each cube's wall
time in which no kernel, copy or set ran on the card (the frozen
``device_summary`` arithmetic, ``tracearith.summarize``)."""


def read(r):
    return r.idle_share
