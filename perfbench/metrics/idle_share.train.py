"""idle_share.train: percent of the traced device span of the train cells' steps
in which no device operation ran (torch.profiler, raw kineto events)."""

from harness.readers import idle_share


def read(run):
    return idle_share(run)
