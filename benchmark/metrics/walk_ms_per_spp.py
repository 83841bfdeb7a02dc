"""Milliseconds a card spends in the triangle walk kernels (K1-K5, by their
tags in the trace) per sample per pixel: their traced time over the traced
iterations, each one sample, and over the cards.  Nothing to read without
a trace, or in a scene whose walks launch no kernel."""


def read(m):
    t = m["traces"]
    if not t or not any(s["traversal_s"] for s in t):
        return None
    return 1e3 * sum(sum(s["traversal_s"].values()) / len(s["busy_s"]) for s in t) / len(t)
