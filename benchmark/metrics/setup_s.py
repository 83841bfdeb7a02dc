"""Seconds from the process's start to the window's: interpreter, torch and
the CUDA context, the scene's tables, the kernel libraries, the seed and the
warm-up iteration that captures the CUDA graphs (host clock)."""


def read(m):
    return m["setup_s"]
