"""CUDA runtime calls that put work on a card (graph and kernel launches,
copies, fills) per sample per pixel, from the traced iterations."""


def read(m):
    t = m["traces"]
    return sum(s["host_launches"] for s in t) / len(t) if t else None
