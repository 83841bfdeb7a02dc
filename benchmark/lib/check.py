"""The comparison that decides `correct`: the window's film against the plain
reference (benchmark/reference), path for path.

Both sides draw each path's random numbers from the same counter stream, so a
path the program traced right is the reference's up to rounding, and a path
a rounding tipped (a grazing hit, a lobe choice at its threshold) differs
whole.  A program that rounds otherwise than the reference (a fused kernel,
FMA contraction) nudges many paths by far less than a hundredth and tips a
few in a hundred thousand.  Two numbers are compared:

- `frame_mismatch_pct`, the share of the window's last iteration's paths
  that disagree, over every pixel: the program's film after it against its
  film before it plus the reference's radiance for that iteration, so every
  pixel of the timed path, on every card, is judged once.  A path disagrees
  where a channel differs by more than REL of the reference's radiance plus
  the rounding of the film's last add;
- `film_error_pct`, the share of the film's light that disagrees, over
  pixels drawn from the seed: the sum of |program - reference| over the
  sum of the reference, the program's accumulated film against the
  reference's own sum of every iteration from the first, in the same order,
  so the accumulation is judged from zero and a few tipped paths among the
  hundreds a pixel sums weigh as what they are.
"""

from __future__ import annotations

import numpy as np
import torch

REL = 1e-2       # of the reference's radiance of the path
ULP = 2.0 ** -22  # of the film's value: one add's rounding, twice over
ABS = 1e-7
FILM_CHUNK = 1 << 19  # paths a reference pass traces at once
FILM_PIXELS = 1024    # pixels of the film check, drawn from the seed


def film_sample(seed: int, npix: int) -> np.ndarray:
    """The film check's pixels for `seed`, sorted."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(npix, min(FILM_PIXELS, npix), replace=False))


def _bad(got: np.ndarray, want: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(P,) pixels where any channel of `got` is off `want` by more than the
    tolerance."""
    tol = REL * np.abs(scale) + ULP * np.abs(want) + ABS
    return (~(np.abs(got - want) <= tol)).any(axis=-1)


def radiance(ref, key, mis: bool, counter, pixel, iteration) -> torch.Tensor:
    """The reference's radiance of paths (pixel, iteration), in chunks."""
    out = []
    for a in range(0, pixel.shape[0], FILM_CHUNK):
        it = iteration[a:a + FILM_CHUNK] if isinstance(iteration, torch.Tensor) else iteration
        out.append(ref.radiance(key, mis, counter[a:a + FILM_CHUNK], pixel[a:a + FILM_CHUNK], it))
    return torch.cat(out)


def compare(ref, key, mis: bool, swizzle: bool, film: np.ndarray, before: np.ndarray,
            first: int, last: int, sample: np.ndarray) -> dict:
    """The two compared numbers.  `film` is the program's (H*W, 3) sum in
    pixel order of iterations 1..last, `before` the sum before its last
    step, which ran iterations first..last; `sample` the pixel indices of
    the film check."""
    dev = ref.device
    counters = ref.counters(swizzle)
    n = film.shape[0]
    pix = torch.arange(n, device=dev)
    want = before.astype(np.float32)
    mag = np.zeros_like(want)
    for it in range(first, last + 1):  # the step's order of adds
        c = radiance(ref, key, mis, counters, pix, it).float().cpu().numpy()
        want = (want + c).astype(np.float32)
        mag += np.abs(c)
    frame_bad = _bad(film, want, mag)

    sp = torch.as_tensor(sample, device=dev)
    its = torch.arange(1, last + 1, device=dev)
    p_all = sp.repeat(last)
    it_all = its.repeat_interleave(sp.shape[0])
    cs = radiance(ref, key, mis, counters[p_all], p_all, it_all).float().cpu().numpy()
    cs = cs.reshape(last, sample.shape[0], 3)
    acc = np.zeros((sample.shape[0], 3), np.float32)
    for k in range(last):  # the film's order of adds
        acc = (acc + cs[k]).astype(np.float32)
    err = np.abs(film[sample].astype(np.float64) - acc).sum()
    return {"frame_mismatch_pct": 100.0 * float(frame_bad.mean()),
            "film_error_pct": 100.0 * float(err / max(np.abs(acc.astype(np.float64)).sum(), 1e-30))}
