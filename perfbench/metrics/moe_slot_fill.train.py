"""moe_slot_fill.train: percent of the expert slots the program's MoE
offers that hold a kept pair, from its counters (``moe.pairs`` -
``moe.pairs_dropped``) / ``moe.slots`` over the traced stretch."""

from harness.spans import counter_share


def read(run):
    return counter_share(run, [("moe.pairs", 1), ("moe.pairs_dropped", -1)],
                         "moe.slots")
