"""How many of the centers that the window's lanes opened are wrong: an
index outside the points, a center whose coordinates are not the float32
point at its index (the precision the configuration states), or a center
that had no probability when it opened (it repeats the quantised point of
an earlier center of its lane; see `portbench.reference`).  An exact
comparison: limit 0."""

import numpy as np

from portbench.reference import zero_probability_opens


def compute(ctx):
    pts32 = ctx.points.astype(np.float32)
    n = len(ctx.points)
    answered = [r for r in ctx.requests if r.error is None]
    if not answered:
        return None
    out = 0
    for r in answered:
        for idx, centers in zip(r.indices, r.centers):
            inside = (idx >= 0) & (idx < n)
            out += int(np.count_nonzero(~inside))
            idx = idx[inside]
            got = centers[inside]
            out += int(np.count_nonzero(
                (got != pts32[idx].astype(np.float64)).any(axis=1)))
            out += zero_probability_opens(ctx.reference.q, idx)
    return out
