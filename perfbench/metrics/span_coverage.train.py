"""span_coverage.train: percent of the traced device time that the
program's layer spans own (embed, attention, attention.backward, moe and
its parts, head, loss, step.optimizer: harness/spans.py LAYERS), by launch
or through the autograd node of an operation run under one."""

from harness.spans import span_coverage


def read(run):
    return span_coverage(run)
