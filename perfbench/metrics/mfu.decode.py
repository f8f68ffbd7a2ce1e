"""mfu.decode: percent of a window step's time that one H100 needs at its
data-sheet peaks for the step's work, counted from shapes
(harness/counts.py); the whole step's share, which bounds every kernel's."""

from harness.readers import step_mfu


def read(run):
    return step_mfu(run)
