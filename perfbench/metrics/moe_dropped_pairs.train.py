"""moe_dropped_pairs.train: percent of the routed (token, choice) pairs that
the program's MoE drops past their expert's capacity, from its counters
``moe.pairs_dropped`` / ``moe.pairs`` over the traced stretch (forward and
recompute alike)."""

from harness.spans import counter_share


def read(run):
    return counter_share(run, [("moe.pairs_dropped", 1)], "moe.pairs")
