"""The program's `RenderStats.compile_seconds`: the warm-up iteration with
its CUDA-graph captures, ending in a synchronize (host clock)."""


def read(m):
    return m["capture_s"]
