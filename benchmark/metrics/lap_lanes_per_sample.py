"""The pool's lanes summed over the laps of the last iteration, per pixel:
the work the scheduler's sort and shrink ladder leave (the program's
`Renderer.lap_pools`; a sharded renderer keeps none)."""


def read(m):
    pools = m["lap_pools"]
    return sum(pools) / (m["width"] * m["height"]) if pools else None
