"""Helpers for detection modules (reference:
mythril/analysis/module/module_helpers.py)."""

import traceback


def is_prehook() -> bool:
    """True when called from inside the engine's pre-hook dispatch.

    The reference inspects the Python stack for its dispatcher's
    function name; this engine's hook bus records the phase explicitly
    (hooks.py `_PHASE`), which cannot misfire with frame depth or
    renamed dispatchers. The stack scan survives only as a fallback
    for direct calls outside any dispatch (unit tests driving
    _analyze_state by hand)."""
    from mythril_tpu_torch.laser.ethereum.hooks import current_hook_phase

    phase = current_hook_phase()
    if phase is not None:
        return phase == "pre"
    return any("pre_hook" in frame for frame in traceback.format_stack()[-6:])
