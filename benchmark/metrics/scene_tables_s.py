"""The benchmark's span around the Renderer's construction: the scene file
parsed, the BVH and kernel tables built and uploaded (host clock)."""


def read(m):
    return m["scene_tables_s"]
