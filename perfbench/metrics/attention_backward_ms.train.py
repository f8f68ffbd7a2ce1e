"""attention_backward_ms.train: device ms a traced step of the kernels
launched under the program's ``attention.backward`` span
(flash_attention's backward: the plain version recomputed and
differentiated a few kv heads at a time), on the program's own span trace
(harness/spans.py)."""

from harness.spans import span_ms


def read(run):
    return span_ms(run, lambda span: span == "attention.backward")
