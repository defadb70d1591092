"""K2's two fused searches (capture kinds "k2proj.*" and "k2valid.*", by
the layer that called them: tracking, mapping, loop closing), each sampled
call recomputed from its inputs.

- k2_rows_differ: rows (and columns, for the validity search) of the
  sampled calls whose best index, best or second distance differs.
"""

from __future__ import annotations

from slambench.reference import frontend as rf

CAPTURES = ("k2proj", "k2valid")


def check(items, cfg, device, tally) -> None:
    for it in items:
        if len(it["args"]) == 4:
            d1, v1, d2, v2 = it["args"]
            idx, best, second, col_arg, col_min = rf.best_two_valid(d1, v1, d2, v2)
            p_idx, p_best, p_second, p_col = it["out"]
            bad_c = (col_min < rf.BIG) & (p_col.to(col_arg.dtype) != col_arg)
            tally.frac("k2_rows_differ", bad_c.sum(), bad_c.numel())
        else:
            idx, best, second = rf.best_two_projection(*it["args"])
            p_idx, p_best, p_second = it["out"]
        bad = (p_best != best) | (p_second != second) | (
            (best < rf.BIG) & (p_idx.to(idx.dtype) != idx))
        tally.frac("k2_rows_differ", bad.sum(), bad.numel())


def control(items, cfg, device) -> list:
    """Integer Hamming distances have no lower precision: the port's own
    outputs."""
    return items
