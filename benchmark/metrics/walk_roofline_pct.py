"""The traversal kernels' share of their roofline on the benchmark's own
camera and shadow rays: the least time (operations from the benchmark's
walk counts, or bytes, whichever binds) over the kernels' traced time.
Nothing to read in a scene without triangles."""


def read(m):
    w = m["walk"]
    return 100.0 * w["bound_s"] / w["kernel_s"] if w and w["kernel_s"] > 0 else None
