"""Issue and Report: the user-facing analysis output.

The port's copy of the JAX package's analysis/report.py (reference:
mythril/analysis/report.py), which renders letter for letter as it
does. An `Issue` is one finding at one program location (source info
attached later through the contract's source maps); a `Report`
collects deduplicated issues and renders them as text/markdown (jinja2
templates under analysis/templates/), plain json, or the SWC-standard
jsonv2 format.
"""

from __future__ import annotations

import hashlib
import json
import logging
from time import time
from typing import Any, Dict, List, Optional

from jinja2 import Environment, PackageLoader

from mythril_tpu_torch.analysis.swc_data import SWC_TO_TITLE
from mythril_tpu_torch.laser.execution_info import ExecutionInfo
from mythril_tpu_torch.support.signatures import SignatureDB
from mythril_tpu_torch.support.source_support import Source
from mythril_tpu_torch.support.start_time import StartTime
from mythril_tpu_torch.support.support_utils import get_code_hash

log = logging.getLogger(__name__)

#: fixed block context attached to jsonv2 test cases so they replay
REPLAY_BLOCK_CONTEXT = {
    "gasLimit": "0x7d000",
    "gasPrice": "0x773594000",
    "blockCoinbase": "0xcbcbcbcbcbcbcbcbcbcbcbcbcbcbcbcbcbcbcbcb",
    "blockDifficulty": "0xa7d7343662e26",
    "blockGasLimit": "0x7d0000",
    "blockNumber": "0x66e393",
    "blockTime": "0x5bfa4639",
}


class Issue:
    """One security finding at one program location."""

    def __init__(
        self,
        contract,
        function_name,
        address,
        swc_id,
        title,
        bytecode,
        gas_used=(None, None),
        severity=None,
        description_head="",
        description_tail="",
        transaction_sequence=None,
    ):
        self.contract = contract
        self.function = function_name
        self.address = address
        self.swc_id = swc_id
        self.title = title
        self.severity = severity
        self.description_head = description_head
        self.description_tail = description_tail
        self.description = f"{description_head}\n{description_tail}"
        self.min_gas_used, self.max_gas_used = gas_used
        self.transaction_sequence = transaction_sequence
        self.bytecode_hash = get_code_hash(bytecode)
        self.discovery_time = time() - StartTime().global_start_time
        #: which engine produced the witness (e.g. "device-prepass");
        #: None for issues found by the host walk
        self.provenance: Optional[str] = None
        # source info, attached later by add_code_info
        self.filename = None
        self.code = None
        self.lineno = None
        self.source_mapping = None

    # -- views ---------------------------------------------------------
    @property
    def transaction_sequence_users(self):
        return self.transaction_sequence

    @property
    def transaction_sequence_jsonv2(self):
        if not self.transaction_sequence:
            return None
        return self.add_block_data(self.transaction_sequence)

    @staticmethod
    def add_block_data(transaction_sequence: Dict) -> Dict:
        """Attach plausible block context so jsonv2 test cases replay."""
        for step in transaction_sequence["steps"]:
            step.update(REPLAY_BLOCK_CONTEXT)
        return transaction_sequence

    @property
    def as_dict(self):
        fields = {
            "address": self.address,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "max_gas_used": self.max_gas_used,
            "min_gas_used": self.min_gas_used,
            "severity": self.severity,
            "sourceMap": self.source_mapping,
            "swc-id": self.swc_id,
            "title": self.title,
            "tx_sequence": self.transaction_sequence,
        }
        if self.filename and self.lineno:
            fields["filename"] = self.filename
            fields["lineno"] = self.lineno
        if self.code:
            fields["code"] = self.code
        if self.provenance:
            fields["provenance"] = self.provenance
        return fields

    # -- enrichment ----------------------------------------------------
    def add_code_info(self, contract) -> None:
        """Attach file/line/code via the contract's source maps."""
        if not (self.address and hasattr(contract, "get_source_info")):
            self.source_mapping = self.address
            return
        info = contract.get_source_info(
            self.address, constructor=(self.function == "constructor")
        )
        if info is None:
            self.source_mapping = self.address
            return
        self.filename = info.filename
        self.code = info.code
        self.lineno = info.lineno
        if self.lineno is None:
            self._mark_compiler_generated()
        self.source_mapping = info.solc_mapping

    def _mark_compiler_generated(self):
        self.severity = "Low"
        self.description_tail += (
            " This issue is reported for internal compiler generated code."
        )
        self.description = f"{self.description_head}\n{self.description_tail}"
        self.code = ""

    def resolve_function_names(self) -> None:
        """Best-effort function names for each tx step via SignatureDB."""
        steps = (self.transaction_sequence or {}).get("steps")
        if steps is None:
            return
        db = SignatureDB()
        for step in steps:
            selector = step["input"][:10]
            try:
                names = db.get(selector)
                step["name"] = names[0] if names else "unknown"
            except ValueError:
                step["name"] = "unknown"


def _jsonv2_issue(issue: Issue, source_index: int) -> dict:
    extra = {"discoveryTime": int(issue.discovery_time * 10**9)}
    replay = issue.transaction_sequence_jsonv2
    if replay:
        extra["testCases"] = [replay]
    if issue.provenance:
        extra["detectedBy"] = issue.provenance
    return {
        "swcID": "SWC-" + issue.swc_id,
        "swcTitle": SWC_TO_TITLE.get(issue.swc_id, "Unspecified Security Issue"),
        "description": {
            "head": issue.description_head,
            "tail": issue.description_tail,
        },
        "severity": issue.severity,
        "locations": [{"sourceMap": "%d:1:%d" % (issue.address, source_index)}],
        "extra": extra,
    }


class Report:
    """A renderable collection of issues."""

    environment = Environment(
        loader=PackageLoader("mythril_tpu_torch.analysis"), trim_blocks=True
    )

    def __init__(
        self,
        contracts=None,
        exceptions=None,
        execution_info: Optional[List[ExecutionInfo]] = None,
    ):
        self.issues: Dict[bytes, Issue] = {}
        self.solc_version = ""
        self.meta: Dict[str, Any] = {}
        self.source = Source()
        self.source.get_source_from_contracts_list(contracts)
        self.exceptions = exceptions or []
        self.execution_info = execution_info or []
        #: resilience outcome (support/resilience.py): `partial` is True
        #: when the run was cut short (deadline / signal) and the issue
        #: list is knowingly incomplete; `degradation` carries the
        #: structured reason counts and per-contract completion status
        #: ({"reasons": {reason: n}, "contracts": [{"contract", ...,
        #: "complete", "device_complete"?, "skipped"?}]}). Both render
        #: into json and jsonv2 ONLY when set, so clean runs' output is
        #: byte-identical to before the supervisor existed.
        self.partial: bool = False
        self.degradation: Dict[str, Any] = {}

    def append_issue(self, issue: Issue) -> None:
        fingerprint = hashlib.md5(
            (issue.contract + str(issue.address) + issue.title).encode("utf-8")
        )
        issue.resolve_function_names()
        self.issues[fingerprint.digest()] = issue

    def sorted_issues(self):
        rows = [issue.as_dict for issue in self.issues.values()]
        return sorted(rows, key=lambda row: (row["address"], row["title"]))

    # -- renderers -----------------------------------------------------
    def _render_template(self, template_name: str) -> str:
        template = Report.environment.get_template(template_name)
        return template.render(
            filename=self._file_name(), issues=self.sorted_issues()
        )

    def as_text(self) -> str:
        return self._render_template("report_as_text.jinja2")

    def as_markdown(self) -> str:
        return self._render_template("report_as_markdown.jinja2")

    def as_json(self) -> str:
        payload = {
            "success": True,
            "error": None,
            "issues": self.sorted_issues(),
        }
        if self.partial:
            payload["partial"] = True
        if self.degradation:
            payload["degradation"] = self.degradation
        return json.dumps(payload, sort_keys=True)

    def as_swc_standard_format(self) -> str:
        """The jsonv2 (SWC standard) output."""
        rendered = [
            _jsonv2_issue(issue, self.source.get_source_index(issue.bytecode_hash))
            for issue in self.issues.values()
        ]

        meta_data = self.meta
        if self.partial:
            meta_data["partial"] = True
        if self.degradation:
            meta_data["degradation"] = self.degradation
        if self.exceptions:
            meta_data["logs"] = [
                {"level": "error", "hidden": True, "msg": why}
                for why in self.exceptions
            ]
        meta_data["mythril_execution_info"] = {}
        for info in self.execution_info:
            meta_data["mythril_execution_info"].update(info.as_dict())

        return json.dumps(
            [
                {
                    "issues": rendered,
                    "sourceType": self.source.source_type,
                    "sourceFormat": self.source.source_format,
                    "sourceList": self.source.source_list,
                    "meta": meta_data,
                }
            ],
            sort_keys=True,
        )

    def _file_name(self):
        for issue in self.issues.values():
            return issue.filename
