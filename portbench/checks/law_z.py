"""How far the opened centers stray from the seeder's law: over a sample
of the window's lanes drawn from the seed (the configuration's
``law_lanes``), the mean of each step's mid-distribution value under the
reference's law (`portbench.reference.law_mid_values`), as a standard
score: |mean - 1/2| * sqrt(12 N) over N steps.  Under the law the mean is
1/2 and the score a standard normal's size at most."""

import numpy as np

from portbench.reference import law_mid_values


def compute(ctx):
    lanes = [idx for r in ctx.requests if r.error is None
             for idx in r.indices]
    if not lanes:
        return None
    take = min(int(ctx.config.get("law_lanes", 2)), len(lanes))
    pick = ctx.rng.choice(len(lanes), size=take, replace=False)
    mids = law_mid_values(ctx.reference, [lanes[i] for i in sorted(pick)],
                          float(ctx.config["cluster"]["c"]), ctx.device)
    if len(mids) == 0:
        return None
    return float(abs(mids.mean() - 0.5) * np.sqrt(12.0 * len(mids)))
