"""Host reads of device values, counted.

In eager PyTorch every place where the host needs a device value (a
phase gate, the run loop's condition, a loop bound that follows the
data) waits for the card. `read` is the one door for such reads in the
interpreter, so that a run can report how many it made per step.
"""

from __future__ import annotations

#: host reads made through `read` since the last reset
COUNT = 0


def read(t):
    """`t.tolist()` (a Python scalar for a 0-d tensor), counted."""
    global COUNT
    COUNT += 1
    return t.tolist()
