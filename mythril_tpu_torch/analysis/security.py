"""Run detection modules over a finished analysis.

The port's copy of the JAX package's analysis/security.py (reference
parity: mythril/analysis/security.py:15-46): `retrieve_callback_issues`
collects what the hook-driven modules found during execution;
`fire_lasers` additionally runs POST modules over the statespace, their
solver queries on the wrapper's device.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module import ModuleLoader, reset_callback_modules
from mythril_tpu_torch.analysis.module.base import EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.support.model import solver_device

log = logging.getLogger(__name__)


def retrieve_callback_issues(white_list: Optional[List[str]] = None) -> List[Issue]:
    """Issues discovered by callback detection modules during the run."""
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        log.debug("Retrieving results for %s", module.name)
        issues += module.issues
    reset_callback_modules(module_names=white_list)
    return issues


def fire_lasers(statespace, white_list: Optional[List[str]] = None) -> List[Issue]:
    """Run POST modules over the statespace and collect all issues,
    merging in the concrete witnesses the device prepass banked
    (analysis/prepass.py) for locations the host walk did not reach.
    The static pre-screen (analysis/static, computed by SymExecWrapper)
    filters modules whose opcode signature cannot fire on the analyzed
    code: they neither mounted hooks nor run their POST pass. White-list
    validation still happens first, so an invalid -m name errors
    regardless of the screen. The POST modules' queries race on the
    wrapper's `device`."""
    log.info("Starting analysis")
    issues: List[Issue] = []
    screen = getattr(statespace, "static_screen", None)
    with solver_device(getattr(statespace, "device", None)):
        for module in ModuleLoader().get_detection_modules(
            entry_point=EntryPoint.POST, white_list=white_list
        ):
            if screen is not None and type(module).__name__ not in screen:
                log.debug("Static pre-screen skipped %s", module.name)
                continue
            log.info("Executing %s", module.name)
            issues += module.execute(statespace)
    issues += retrieve_callback_issues(white_list)

    device_issues = getattr(statespace, "device_issues", None) or []
    if white_list:
        # honor the user's module selection per finding class: a
        # device witness stands in for exactly one module's finding
        # SWC-107 is claimed by two modules with distinct titles, so
        # the filter keys on (swc, title); None matches any title
        module_claims = {
            "Exceptions": (("110", None),),
            "AccidentallyKillable": (("106", None),),
            "IntegerArithmetics": (("101", None),),
            "UncheckedRetval": (("104", None),),
            "EtherThief": (("105", None),),
            "ExternalCalls": (
                ("107", "External Call To User-Supplied Address"),
            ),
            "StateChangeAfterCall": (
                ("107", "State access after external call"),
            ),
            "ArbitraryDelegateCall": (("112", None),),
            "TxOrigin": (("115", None),),
            "PredictableVariables": (("116", None), ("120", None)),
        }
        allowed = set()
        for module_name, claims in module_claims.items():
            if module_name in white_list:
                allowed.update(claims)
        device_issues = [
            i
            for i in device_issues
            if (i.swc_id, None) in allowed or (i.swc_id, i.title) in allowed
        ]
    if device_issues:
        seen = {
            (issue.contract, issue.address, issue.swc_id) for issue in issues
        }
        fresh = [
            issue
            for issue in device_issues
            if (issue.contract, issue.address, issue.swc_id) not in seen
        ]
        if fresh:
            log.info(
                "Device prepass contributed %d issue(s) the host walk "
                "did not find",
                len(fresh),
            )
        issues += fresh
    return issues
