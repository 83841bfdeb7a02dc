"""Pixel samples completed per second of the window, in millions: the
window's samples times the film's pixels over the seconds from its start to
the synchronize after its last step (host clock)."""


def read(m):
    return m["window_samples"] * m["width"] * m["height"] / m["window_s"] / 1e6
