"""Backend probe and device resolution for the port.

`probe()` reports what the machine offers: whether CUDA is present, the
card's name and compute capability, and whether the hand-written kernel
library has been built. It is a report only: nothing chooses a code
path by it. The paths are chosen by where a tensor lies (a wrapper on a
CPU tensor runs the plain version, on a CUDA tensor the kernel) and by
the `device` a caller passes to an entry point.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on.

    None means the card. Where there is no card, None raises rather than
    carrying on on the CPU: the CPU is used only when a caller asks for
    it by name (`device="cpu"`), as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def probe() -> dict:
    """What the backend offers, as a plain dict."""
    from mythril_tpu_torch.native import build

    out = {
        "torch": torch.__version__,
        "cuda_build": torch.version.cuda,
        "cuda": torch.cuda.is_available(),
        "device_name": None,
        "capability": None,
        "sm90a": False,
        "kernels_built": build.is_built(),
    }
    if out["cuda"]:
        cap = torch.cuda.get_device_capability(0)
        out["device_name"] = torch.cuda.get_device_name(0)
        out["capability"] = f"{cap[0]}.{cap[1]}"
        out["sm90a"] = cap == (9, 0)
    return out
