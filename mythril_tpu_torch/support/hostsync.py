"""Host reads of device values, counted.

In eager PyTorch every place where the host needs a device value (a
phase gate, the run loop's condition, a loop bound that follows the
data) waits for the card. `read` is the one door for such reads in the
interpreter, so that a run can report how many it made per step;
`fetch` is the one door for bulk readbacks (the arena view).
"""

from __future__ import annotations

import torch

#: host reads made through `read` since the last reset
COUNT = 0


def read(t):
    """`t.tolist()` (a Python scalar for a 0-d tensor), counted."""
    global COUNT
    COUNT += 1
    return t.tolist()


def fetch(tensors) -> list:
    """Host numpy copies of `tensors` in one bundled transfer, counted as
    one read: on the card, non-blocking copies into pinned host buffers
    and one synchronize of the current stream."""
    global COUNT
    COUNT += 1
    staged = []
    cuda = None
    for t in tensors:
        if t.device.type == "cuda":
            cuda = t.device
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
        else:
            host = t.clone()
        staged.append(host)
    if cuda is not None:
        torch.cuda.current_stream(cuda).synchronize()
    return [h.numpy() for h in staged]
