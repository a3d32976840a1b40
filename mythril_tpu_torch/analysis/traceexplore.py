"""Serializable statespace dump for `python -m mythril_tpu_torch analyze
-j/--statespace-json`.

The port's copy of the JAX package's analysis/traceexplore.py (reference:
mythril/analysis/traceexplore.py): nodes carrying per-state
machine/account snapshots, edges labeled with simplified branch
conditions — the payload the trace-explorer front end renders.
"""

from __future__ import annotations

import re
from itertools import count

from mythril_tpu_torch.laser.ethereum.cfg import NodeFlags
from mythril_tpu_torch.laser.smt import simplify

PALETTE = [
    {
        "border": "#26996f",
        "background": "#2f7e5b",
        "highlight": {"border": "#fff", "background": "#28a16f"},
    },
    {
        "border": "#9e42b3",
        "background": "#842899",
        "highlight": {"border": "#fff", "background": "#933da6"},
    },
    {
        "border": "#b82323",
        "background": "#991d1d",
        "highlight": {"border": "#fff", "background": "#a61f1f"},
    },
    {
        "border": "#4753bf",
        "background": "#3b46a1",
        "highlight": {"border": "#fff", "background": "#424db3"},
    },
]

# kept under its historical name for importers
colors = PALETTE


class _ContractPalette:
    """Stable contract-name -> color assignment."""

    def __init__(self, names):
        self._next = count()
        self._colors = {n: self._pick() for n in names}

    def _pick(self):
        return PALETTE[next(self._next) % len(PALETTE)]

    def color_of(self, name):
        if name not in self._colors:
            self._colors[name] = self._pick()
        return self._colors[name]


def _abbreviate_code(node) -> str:
    """The node's disassembly with long hex blobs elided and the
    function name substituted at entry points."""
    code = node.get_cfg_dict()["code"]
    code = re.sub(
        "([0-9a-f]{8})[0-9a-f]+", lambda m: m.group(1) + "(...)", code
    )
    if NodeFlags.FUNC_ENTRY in node.flags:
        code = re.sub("JUMPDEST", node.function_name, code)
    return code


def _snapshot_accounts(state) -> list:
    out = []
    for address, account in state.accounts.items():
        view = account.as_dict
        view.pop("code", None)
        view["balance"] = str(view["balance"])
        storage = {
            str(k): str(view["storage"][k])
            for k in view["storage"].printable_storage
        }
        out.append({"address": address, "storage": storage})
    return out


def _snapshot_machine(state) -> dict:
    machine = state.mstate.as_dict
    machine["stack"] = [str(word) for word in machine["stack"]]
    memory = machine.pop("memory")
    machine["memory"] = [str(memory[i]) for i in range(min(len(memory), 128))]
    return machine


def _edge_label(edge) -> str:
    if edge.condition is None:
        return ""
    label = str(simplify(edge.condition)).replace("\n", "")
    # big decimal literals read better as hex
    return re.sub(
        r"([^_])([\d]{2}\d+)",
        lambda m: m.group(1) + hex(int(m.group(2))),
        label,
    )


def get_serializable_statespace(statespace) -> dict:
    """Convert a finished statespace into JSON-ready nodes and edges."""
    palette = _ContractPalette(
        statespace.accounts[k].contract_name for k in statespace.accounts
    )

    nodes = []
    for node_key, node in statespace.nodes.items():
        code = _abbreviate_code(node)
        lines = code.split("\\n")
        preview = (
            code
            if len(lines) < 7
            else "\\n".join(lines[:6]) + "\\n(click to expand +)"
        )
        preview = preview.replace("\\n", "\n")
        code = code.replace("\\n", "\n")

        nodes.append(
            {
                "id": str(node_key),
                "func": str(node.function_name),
                "label": preview,
                "code": code,
                "truncated": preview,
                "states": [
                    {
                        "machine": _snapshot_machine(s),
                        "accounts": _snapshot_accounts(s),
                    }
                    for s in node.states
                ],
                "color": palette.color_of(node.get_cfg_dict()["contract_name"]),
                "instructions": code.split("\n"),
            }
        )

    edges = [
        {
            "from": str(edge.as_dict["from"]),
            "to": str(edge.as_dict["to"]),
            "arrows": "to",
            "label": _edge_label(edge),
            "smooth": {"type": "cubicBezier"},
        }
        for edge in statespace.edges
    ]

    return {"edges": edges, "nodes": nodes}
