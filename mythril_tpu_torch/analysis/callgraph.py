"""Interactive call-graph HTML for `python -m mythril_tpu_torch analyze
--graph`.

The port's copy of the JAX package's analysis/callgraph.py (reference:
mythril/analysis/callgraph.py): turns the statespace into
vis.js node/edge dicts and renders the HTML page (hierarchical
left-to-right layout; `--phrack` switches to the monochrome zine
look). The vis.js option trees are assembled from small shared pieces
instead of spelled out literally.
"""

from __future__ import annotations

import re

from jinja2 import Environment, PackageLoader, select_autoescape

from mythril_tpu_torch.laser.ethereum.cfg import NodeFlags
from mythril_tpu_torch.laser.smt import simplify

MAX_PREVIEW_LINES = 6


def _edge_font(color: str, face: str = "arial") -> dict:
    return {
        "color": color,
        "face": face,
        "background": "none",
        "strokeWidth": 0,
        "strokeColor": "#ffffff",
        "align": "horizontal",
        "multi": False,
        "vadjust": 0,
    }


def _node_style(font_color: str, face: str = None) -> dict:
    font = {"align": "left", "color": font_color}
    if face:
        font["face"] = face
    return {
        "color": "#000000",
        "borderWidth": 1,
        "borderWidthSelected": 2,
        "chosen": True,
        "shape": "box",
        "font": font,
    }


default_opts = {
    "autoResize": True,
    "height": "100%",
    "width": "100%",
    "manipulation": False,
    "layout": {
        "improvedLayout": True,
        "hierarchical": {
            "enabled": True,
            "levelSeparation": 450,
            "nodeSpacing": 200,
            "treeSpacing": 100,
            "blockShifting": True,
            "edgeMinimization": True,
            "parentCentralization": False,
            "direction": "LR",
            "sortMethod": "directed",
        },
    },
    "nodes": _node_style("#FFFFFF"),
    "edges": {"font": _edge_font("#FFFFFF")},
    "physics": {"enabled": False},
}

phrack_opts = {
    "nodes": dict(
        _node_style("#000000", face="courier new"),
        borderWidthSelected=1,
        shapeProperties={"borderDashes": False, "borderRadius": 0},
    ),
    "edges": {"font": _edge_font("#000000", face="courier new")},
}


def _shade(border: str, background: str, highlight_bg: str) -> dict:
    return {
        "border": border,
        "background": background,
        "highlight": {"border": border, "background": highlight_bg},
    }


default_colors = [
    _shade("#26996f", "#2f7e5b", "#28a16f"),
    _shade("#9e42b3", "#842899", "#933da6"),
    _shade("#b82323", "#991d1d", "#a61f1f"),
    _shade("#4753bf", "#3b46a1", "#424db3"),
]

phrack_color = _shade("#000000", "#ffffff", "#ffffff")

_ELIDE_HEX = ("([0-9a-f]{8})[0-9a-f]+", lambda m: m.group(1) + "(...)")


def _listing_line(node, state) -> str:
    """One disassembly line for a state, or None past end-of-code."""
    try:
        instr = state.get_current_instruction()
    except IndexError:
        return None
    if instr["opcode"].startswith("PUSH"):
        line = "%d %s %s" % (instr["address"], instr["opcode"], instr["argument"])
    elif (
        instr["opcode"].startswith("JUMPDEST")
        and NodeFlags.FUNC_ENTRY in node.flags
        and instr["address"] == node.start_addr
    ):
        line = node.function_name
    else:
        line = "%d %s" % (instr["address"], instr["opcode"])
    return re.sub(*_ELIDE_HEX, line)


def extract_nodes(statespace):
    nodes = []
    palette = {}
    for node_key, node in statespace.nodes.items():
        listing = [
            line
            for line in (_listing_line(node, s) for s in node.states)
            if line is not None
        ]
        if len(listing) <= MAX_PREVIEW_LINES:
            preview = "\n".join(listing)
        else:
            preview = (
                "\n".join(listing[:MAX_PREVIEW_LINES]) + "\n(click to expand +)"
            )

        who = node.get_cfg_dict()["contract_name"]
        if who not in palette:
            palette[who] = default_colors[len(palette) % len(default_colors)]

        nodes.append(
            {
                "id": str(node_key),
                "color": palette.get(who, default_colors[0]),
                "size": 150,
                "fullLabel": "\n".join(listing),
                "label": preview,
                "truncLabel": preview,
                "isExpanded": False,
            }
        )
    return nodes


def extract_edges(statespace):
    edges = []
    for edge in statespace.edges:
        label = ""
        if edge.condition is not None:
            label = str(simplify(edge.condition)).replace("\n", "")
        label = re.sub(
            r"([^_])([\d]{2}\d+)",
            lambda m: m.group(1) + hex(int(m.group(2))),
            label,
        )
        edges.append(
            {
                "from": str(edge.as_dict["from"]),
                "to": str(edge.as_dict["to"]),
                "arrows": "to",
                "label": label,
                "smooth": {"type": "cubicBezier"},
            }
        )
    return edges


def generate_graph(
    statespace,
    title="Mythril-TPU / LASER Symbolic VM",
    physics=False,
    phrackify=False,
):
    """Render the callgraph HTML for a finished statespace."""
    env = Environment(
        loader=PackageLoader("mythril_tpu_torch.analysis"),
        autoescape=select_autoescape(["html", "xml"]),
    )
    opts = default_opts
    opts["physics"]["enabled"] = physics
    return env.get_template("callgraph.html").render(
        title=title,
        nodes=extract_nodes(statespace),
        edges=extract_edges(statespace),
        phrackify=phrackify,
        opts=opts,
    )
