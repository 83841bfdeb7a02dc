"""Device ops (kernels, copies, fills; each kernel of a replayed graph
counted) on all cards per sample per pixel, from the traced iterations."""


def read(m):
    t = m["traces"]
    return sum(sum(s["device_ops"].values()) for s in t) / len(t) if t else None
