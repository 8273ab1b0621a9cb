"""Faults planted under the timed path, to show that the check catches
them (the tests, and ``run.py --fault <name>`` for a reading on the card).

Each plant replaces one function of the port for the life of the process
and returns a function that puts it back.
"""

from __future__ import annotations

__all__ = ["FAULTS", "plant"]


def _swap(module, name, new):
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)


def state_unchanged():
    """A step that returns its state unchanged: the sweeps that open a
    center leave every weight as it was (the tile sums still add up)."""
    from repro_torch.kernels import ops

    def sweep(lo, hi, x, weights, **kw):
        return weights

    def sweep_tiles(lo, hi, x, weights, *, block_n, **kw):
        b = weights.shape[0]
        return weights, weights.reshape(b, -1, block_n).sum(dim=2)

    undo = [_swap(ops, "tree_sep_update_lanes", sweep),
            _swap(ops, "tree_sep_update_tiles_lanes", sweep_tiles)]
    return lambda: [u() for u in undo]


def half_the_rows():
    """Half of the batch left out, the mean taken over the rest: each cost
    summed over every other point and doubled."""
    from repro_torch.core import plan

    orig = plan._cost_program
    return _swap(plan, "_cost_program",
                 lambda points, centers, mask=None, chunk=65536:
                 2.0 * orig(points[::2], centers))


def center_altered():
    """An answer altered where it is produced: each lane's last center
    replaced by its first."""
    from repro_torch.core import device_seeding as ds

    undo = []
    for name in ("stacked_rejection_sampling", "stacked_fast_kmeanspp"):
        orig = getattr(ds, name)

        def altered(*args, _orig=orig, **kw):
            out = _orig(*args, **kw)
            chosen = out[0] if isinstance(out, tuple) else out
            chosen[:, -1] = chosen[:, 0]
            return out

        undo.append(_swap(ds, name, altered))
    return lambda: [u() for u in undo]


def lanes_shared():
    """Lanes that are not seedings of their own: every lane of a request
    handed lane 0's centers (and trials), as a solve of one lane copied
    into the rest, or one generator shared by all, would hand them."""
    from repro_torch.core import device_seeding as ds

    undo = []
    for name in ("stacked_rejection_sampling", "stacked_fast_kmeanspp"):
        orig = getattr(ds, name)

        def shared(*args, _orig=orig, **kw):
            out = _orig(*args, **kw)
            for t in out if isinstance(out, tuple) else (out,):
                t[1:] = t[0]
            return out

        undo.append(_swap(ds, name, shared))
    return lambda: [u() for u in undo]


def cost_altered():
    """An answer altered where it is produced: each cost 0.1% high."""
    from repro_torch.core import plan

    orig = plan._cost_program
    return _swap(plan, "_cost_program",
                 lambda *a, **kw: orig(*a, **kw) * 1.001)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_rows,
                                  center_altered, lanes_shared,
                                  cost_altered)}


def plant(name: str):
    """Plant fault `name`; returns the function that removes it."""
    return FAULTS[name]()
