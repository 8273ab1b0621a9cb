"""The widest relative gap between a lane's cost as the port returned it
and the reference's float64 cost of the same centers (the points at the
lane's indices), over every lane of every request of the window."""

import numpy as np
import torch

from portbench.reference import cost


def compute(ctx):
    answered = [r for r in ctx.requests if r.error is None]
    if not answered:
        return None
    pts = torch.as_tensor(ctx.points, dtype=torch.float64, device=ctx.device)
    n = pts.shape[0]
    widest = 0.0
    for r in answered:
        for idx, got in zip(r.indices, r.cost):
            if idx.min() < 0 or idx.max() >= n or not np.isfinite(got):
                return float("inf")
            want = cost(pts, pts[torch.as_tensor(idx, device=pts.device)])
            gap = abs(float(got) - want) / want if want > 0 else \
                abs(float(got))
            widest = max(widest, gap)
    return widest
