"""The sweep's bytes from its shapes: PERF.md's bounds of rows 1 and 2 at
one lane (311,029 rows padded to 311,296, 14 code levels)."""

from portbench import counts


def _ms(nbytes):
    return round(counts.bound_seconds(nbytes) * 1e3, 6)


def test_rows_1_and_2_of_the_kernel_table_at_one_lane():
    n_pad = counts.padded_rows(311_029, 512)
    assert n_pad == 311_296
    assert _ms(counts.sweep_bytes(n_pad, 14)) == 0.011151
    assert _ms(counts.sweep_bytes(n_pad, 14, tile=512)) == 0.011152


def test_lanes_share_the_codes_and_own_their_weights():
    one = counts.sweep_bytes(1024, 10, 1)
    ten = counts.sweep_bytes(1024, 10, 10)
    assert ten - one == 9 * 8 * 1024


def test_a_center_step_reads_every_tree_once_and_the_weights_once():
    n_pad, levels, lanes, tile = 2_458_624, 15, 10, 512
    step = counts.center_step_bytes(n_pad, levels, 3, lanes, tile)
    sweeps = (2 * counts.sweep_bytes(n_pad, levels, lanes)
              + counts.sweep_bytes(n_pad, levels, lanes, tile))
    assert sweeps - step == 2 * lanes * 8 * n_pad
    assert step == 3 * 15 * 8 * n_pad + 80 * n_pad + 10 * 4802 * 4
