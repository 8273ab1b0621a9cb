"""The bytes a multi-tree sweep has to move, from its shapes alone.

Each input is read once and each output written once, whatever the kernel
reads again; the count is the same whatever implements the sweep.  A
tree's cell codes are two int32 planes a level (8 bytes a row a level);
the sweep reads each lane's f32 weights and writes them back, and the
tiles variant also writes one f32 sum a tile a lane.  Lanes that share
one dataset (a stride-0 lane axis) share its codes: they are counted once.

The least time is the bytes over the card's bandwidth (NVIDIA's data sheet
for the H100 SXM, at its 700 W power limit).
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "sweep_bytes", "center_step_bytes",
           "bound_seconds", "padded_rows"]

HBM_BYTES_PER_S = 3.35e12


def padded_rows(n: int, tile: int) -> int:
    """The sweep's rows: n padded up to a whole tile."""
    return -(-int(n) // int(tile)) * int(tile)


def sweep_bytes(n_pad: int, levels: int, lanes: int = 1,
                tile: int | None = None) -> int:
    """One tree's sweep over `lanes` lanes of one dataset: its codes
    (`levels` levels of two int32 planes), each lane's weights read and
    written, and, with `tile`, each lane's tile sums written."""
    sums = lanes * (n_pad // tile) * 4 if tile else 0
    return levels * 8 * n_pad + lanes * 8 * n_pad + sums


def center_step_bytes(n_pad: int, levels: int, trees: int, lanes: int,
                      tile: int) -> int:
    """Opening one center in every lane (MULTITREEOPEN over all trees): the
    codes of every tree, each lane's weights read once and written once,
    and each lane's tile sums (the sampler's input) written once: one
    sweep over the codes of all trees' levels."""
    return sweep_bytes(n_pad, trees * levels, lanes, tile)


def bound_seconds(nbytes: float) -> float:
    """The least time in which the card moves `nbytes`."""
    return nbytes / HBM_BYTES_PER_S
