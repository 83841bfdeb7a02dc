"""How far the busiest card's busy seconds per sample lie above the mean
over the cards, in percent of the mean: the lockstep waits for the slowest.
Only where the film is split over several cards."""


def read(m):
    t = m["traces"]
    if not t or len(t[0]["busy_s"]) < 2:
        return None
    spread = []
    for s in t:
        b = list(s["busy_s"].values())
        mean = sum(b) / len(b)
        spread.append(100.0 * (max(b) - mean) / mean)
    return sum(spread) / len(spread)
