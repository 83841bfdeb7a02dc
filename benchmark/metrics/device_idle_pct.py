"""The share of the wall a card is idle: 1 minus its busy seconds per
sample (the union of its ops' intervals in the traced iterations) over the
window's wall per sample, timed before any trace; the mean over cards."""


def read(m):
    t = m["traces"]
    if not t:
        return None
    wall = m["window_s"] / m["window_samples"]
    busy = sum(sum(s["busy_s"].values()) / len(s["busy_s"]) for s in t) / len(t)
    return 100.0 * (1.0 - busy / wall)
