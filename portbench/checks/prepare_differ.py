"""How many values of the port's prepare differ from the reference's, over
a sample of rows drawn from the seed: the quantised coordinates, each
tree's cell codes (both int32 planes of every level), and for the
rejection seeder the f32 copy of the points and the LSH bucket keys; with
the tree statics (scale, levels, M).  An exact comparison: limit 0.

A part the port did not hand over, or of another shape, counts as every
value of it differing."""

import numpy as np

from portbench.reference import split_codes


def _differ(got, want) -> int:
    want = np.asarray(want)
    if got is None or np.shape(got) != want.shape:
        return int(want.size)
    return int(np.count_nonzero(np.asarray(got) != want))


def compute(ctx):
    prep = ctx.prepared
    if prep is None:
        return None
    ref = ctx.reference
    rows = ref.q[ctx.rows]
    out = _differ(prep["seed_pts"], rows)
    out += _differ(np.asarray(prep["statics"]), np.asarray(ref.trees.statics,
                                                           dtype=np.float64))
    lo, hi = split_codes(ref.trees.codes(rows))
    out += _differ(prep["codes_lo"], lo) + _differ(prep["codes_hi"], hi)
    if ref.lsh is not None:
        klo, khi = split_codes(ref.lsh.keys(rows))
        out += _differ(prep.get("points"), rows.astype(np.float32))
        out += _differ(prep.get("keys_lo"), klo)
        out += _differ(prep.get("keys_hi"), khi)
    return out
