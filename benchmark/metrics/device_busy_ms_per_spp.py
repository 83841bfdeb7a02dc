"""Milliseconds a card is busy per sample per pixel (the union of its ops'
intervals in the traced iterations; the mean over cards): the device's side
of a step, steadier than the window's rate, which also holds the host's
gaps."""


def read(m):
    t = m["traces"]
    if not t:
        return None
    return 1e3 * sum(sum(s["busy_s"].values()) / len(s["busy_s"]) for s in t) / len(t)
