"""Rays the program counts (every live path ray a bounce, plus a shadow ray
per NEE-eligible lane: `RenderStats.rays_traced`) per pixel sample booked."""


def read(m):
    booked = m["samples_booked"]
    return m["rays_traced"] / booked / (m["width"] * m["height"]) if booked else None
