"""moe_ms.train: device ms a traced step of the kernels of the program's MoE
layers: launched under its ``moe`` spans (the forward, and under remat the
recompute in backward) or by the autograd nodes of operations run there
(their gradients), on the program's own span trace (harness/spans.py)."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, lambda span: span is not None
                   and (span == "moe" or span.startswith("moe.")))
