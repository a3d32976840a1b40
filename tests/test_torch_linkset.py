"""The port's corpus linker (analysis/static/linkset.py) against the JAX package's.

Held live against the JAX package on the CPU, on corpusgen's link
fixtures (proxy pairs with and without a storage collision and across
upgrades, minimal proxies, cross-call pairs, a call cycle, a caller whose
callee is missing, the bench corpus's link rows) and seeded mixes of them:

- `LinkSet.as_dict()` (the `graph --json` payload, its wall time left
  out), `linked_fingerprints`, `node_meta`, `arena_plan`, `findings` and
  `stats` equal the JAX ones on every fixture;
- the linker cases of the JAX tests/analysis/test_callgraph.py (SCC
  widening, link-unresolved, escape masks, proxy pairing and collisions,
  the arena plan, the linked fingerprint that moves only the forwarding
  selector) on the port;
- `python -m mythril_tpu_torch graph` (text and `--json`) prints what the
  JAX `myth graph` prints on the same files;
- the link counters reach the metrics registry (`mtpu_static_link_*`),
  and a summary's lint findings carry the link checks, as in the JAX
  package.

Host work only: nothing here compiles a JAX program.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mythril_tpu_torch.analysis.corpusgen import (
    cross_call_pair,
    minimal_proxy,
    proxy_pair,
    synth_bench_corpus,
)
from mythril_tpu_torch.analysis.static import (
    GRAPH_SCHEMA_VERSION,
    LINK_CHECKS,
    LINT_CHECKS,
    link_corpus,
    link_stat_counts,
    summary_for,
)
from mythril_tpu_torch.analysis.static.callgraph import (
    PROV_CONSTANT,
    PROV_MINIMAL_PROXY,
    PROV_PROXY_SLOT,
)
from mythril_tpu_torch.analysis.static.linkset import address_from_name
from mythril_tpu_torch.analysis.static.taint import TAINT_ANY, TAINT_ATTACKER

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LINK_PREFIXES = ("proxy", "impl", "minproxy", "mincallee", "crosscaller", "crosscallee")


def _cycle_rows():
    """Two cross-call callers whose baked targets resolve to each other."""
    caller_a, caller_b = cross_call_pair(seed=0)[0], cross_call_pair(seed=1)[0]
    target_a = address_from_name(cross_call_pair(seed=0)[1][2])
    target_b = address_from_name(cross_call_pair(seed=1)[1][2])
    return [(caller_a[0], "", f"a@0x{target_b:040x}"),
            (caller_b[0], "", f"b@0x{target_a:040x}")]


def _seeded_mix(seed: int):
    """A shuffled mix of link fixtures drawn from a seeded numpy stream."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(3):
        kind, s = int(rng.integers(0, 3)), int(rng.integers(0, 9))
        rows += (proxy_pair(seed=s, variant=int(rng.integers(0, 3)),
                            collide=bool(rng.integers(0, 2))),
                 minimal_proxy(seed=s), cross_call_pair(seed=s))[kind]
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


FIXTURES = {
    "proxy_pair_0": lambda: proxy_pair(seed=0),
    "proxy_pair_collide": lambda: proxy_pair(seed=1, collide=True),
    "proxy_pair_clean": lambda: proxy_pair(seed=2, collide=False),
    "proxy_pair_5_0": lambda: proxy_pair(seed=5, variant=0),
    "proxy_pair_5_1": lambda: proxy_pair(seed=5, variant=1),
    "minimal_proxy": lambda: minimal_proxy(seed=0),
    "cross_call": lambda: cross_call_pair(seed=0),
    "caller_only": lambda: cross_call_pair(seed=2)[:1],
    "cycle": _cycle_rows,
    "graph_dir": lambda: proxy_pair(seed=0) + minimal_proxy(seed=0) + cross_call_pair(seed=0),
    "bench_links": lambda: [row for row in synth_bench_corpus(
        32, proxy_pairs=1, minimal_proxies=1, cross_call_pairs=1)
        if row[2].split("#")[0] in LINK_PREFIXES],
    "mix_seed_0": lambda: _seeded_mix(0),
    "mix_seed_1": lambda: _seeded_mix(1),
}


def _both(rows):
    from mythril_tpu.analysis.static import link_corpus as jax_link_corpus

    return link_corpus(rows), jax_link_corpus(rows)


def _no_wall(payload):
    payload = json.loads(json.dumps(payload))
    payload["stats"].pop("wall_ms")
    return payload


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_graph_payload_equals_the_jax_one(fixture):
    port, jax = _both(FIXTURES[fixture]())
    assert _no_wall(port.as_dict()) == _no_wall(jax.as_dict())
    assert port.as_dict()["schema_version"] == GRAPH_SCHEMA_VERSION


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_per_node_surfaces_equal_the_jax_ones(fixture):
    """linked_fingerprints, node_meta for every node (and for an unknown
    code hash), arena_plan, findings and stats."""
    port, jax = _both(FIXTURES[fixture]())
    assert set(port.nodes) == set(jax.nodes)
    for ch in sorted(port.nodes) + ["0x" + "00" * 32]:
        assert port.linked_fingerprints(ch) == jax.linked_fingerprints(ch)
        assert port.node_meta(ch) == jax.node_meta(ch)
    assert port.arena_plan() == jax.arena_plan()
    assert port.findings() == jax.findings()
    assert {k: v for k, v in port.stats().items() if k != "wall_ms"} == {
        k: v for k, v in jax.stats().items() if k != "wall_ms"}


@pytest.mark.parametrize("name", ["impl#0v1@0x" + "ab" * 20, "x@0x" + "0F" * 20, "plain",
                                  "", "a@0x12"])
def test_address_from_name_equals_the_jax_one(name):
    from mythril_tpu.analysis.static.linkset import address_from_name as jax_address

    assert address_from_name(name) == jax_address(name)


def test_tarjan_equals_the_jax_one():
    """The SCC emission order on a seeded random graph (the escape
    fixpoint's processing order)."""
    from mythril_tpu.analysis.static.linkset import _tarjan as jax_tarjan
    from mythril_tpu_torch.analysis.static.linkset import _tarjan

    rng = np.random.default_rng(7)
    nodes = [f"n{i:02d}" for i in range(24)]
    adjacency = {n: {nodes[j] for j in rng.integers(0, 24, int(rng.integers(0, 4)))}
                 for n in nodes}
    assert _tarjan(adjacency) == jax_tarjan(adjacency)


# ---------------------------------------------------------------------------
# the JAX tests/analysis/test_callgraph.py linker cases, on the port
# ---------------------------------------------------------------------------
def test_cycle_widens_escape_and_names_link_cycle():
    linkset = link_corpus(_cycle_rows())
    data = linkset.resolve()
    assert len(data["cyclic"]) == 2
    for ch in linkset.nodes:
        escapes = data["escapes"][ch]
        sel = next(s for s in escapes if s != "*")
        assert escapes[sel]["mask"] == TAINT_ANY and escapes[sel]["widened"] is True
        fps, problems = linkset.linked_fingerprints(ch)
        assert problems.get(sel) == "link-cycle" and sel not in fps
    assert data["stats"]["escape_widened"] >= 2


def test_unresolved_edge_names_link_unresolved():
    rows = cross_call_pair(seed=2)
    caller_only = link_corpus(rows[:1])
    (edge,) = caller_only.resolve()["edges"]
    assert edge["resolved"] is False
    fps, problems = caller_only.linked_fingerprints(edge["caller"])
    assert problems.get(edge["selector"]) == "link-unresolved"
    assert edge["selector"] not in fps
    fps2, problems2 = link_corpus(rows).linked_fingerprints(edge["caller"])
    assert problems2 == {} and edge["selector"] in fps2


def test_escape_mask_carries_attacker_args():
    linkset = link_corpus(cross_call_pair(seed=0))
    (edge,) = linkset.resolve()["edges"]
    row = linkset.resolve()["escapes"][edge["caller"]][edge["selector"]]
    assert row["mask"] & TAINT_ATTACKER and row["widened"] is False
    assert row.get("return_to_guard") is True


@pytest.mark.parametrize("collide", [True, False])
def test_proxy_pair_and_collision(collide):
    linkset = link_corpus(proxy_pair(seed=1 if collide else 2, collide=collide))
    data = linkset.resolve()
    (pair,) = data["pairs"]
    assert pair["kind"] == "eip1967" and pair["upgradeable"] is True
    fired = any(f["check"] == "proxy-storage-collision" for f in linkset.findings())
    assert fired is collide
    if collide:
        (collision,) = data["collisions"]
        assert collision["proxy"] == pair["proxy"] and collision["slots"] == ["0x0"]
    else:
        assert data["collisions"] == []


def test_arena_plan_colocates_pair():
    linkset = link_corpus(proxy_pair(seed=0))
    (edge,) = linkset.resolve()["edges"]
    plan = linkset.arena_plan()
    assert plan[edge["caller"]] == [edge["callee"]] and plan[edge["callee"]] == []


@pytest.mark.parametrize("seed", [3, 5])
def test_linked_fingerprint_moves_only_forward_selector(seed):
    before = link_corpus(proxy_pair(seed=seed, variant=0))
    after = link_corpus(proxy_pair(seed=seed, variant=1))
    proxy_ch = next(ch for ch, node in before.nodes.items() if node.is_proxy)
    assert proxy_ch in after.nodes
    fps_before, prob_before = before.linked_fingerprints(proxy_ch)
    fps_after, prob_after = after.linked_fingerprints(proxy_ch)
    assert prob_before == prob_after == {}
    moved = [s for s in fps_before if fps_before[s] != fps_after[s]]
    assert moved == [f"0x{(0xCA11AB1E + seed) & 0xFFFFFFFF:08x}"]
    assert fps_before["0x3659cfe6"] == fps_after["0x3659cfe6"]


def test_lint_proxy_storage_collision_needs_the_pair():
    rows = proxy_pair(seed=7, collide=True)
    assert "proxy-storage-collision" not in {f["check"] for f in summary_for(rows[0][0]).findings()}
    (finding,) = [f for f in link_corpus(rows).findings()
                  if f["check"] == "proxy-storage-collision"]
    assert finding["contract"] == rows[0][2] and rows[1][2] in finding["detail"]


@pytest.mark.parametrize("fixture", ["proxy_pair_0", "minimal_proxy", "cross_call"])
def test_summary_findings_carry_the_link_checks(fixture):
    """StaticSummary.findings() appends the link node's checks, as in the
    JAX package: the rows equal the JAX summary's."""
    from mythril_tpu.analysis.static import summary_for as jax_summary_for

    assert LINK_CHECKS <= LINT_CHECKS
    for code, _, _ in FIXTURES[fixture]():
        assert summary_for(code).findings() == jax_summary_for(code).findings()


def test_link_counters_reach_the_registry():
    """`_bump` feeds both `static.link.*` and `mtpu_static_link_*_total`."""
    from mythril_tpu_torch.analysis.static import clear_static_cache
    from mythril_tpu_torch.observe.registry import registry

    def series(key):
        return sum((registry().snapshot().get(f"mtpu_static_link_{key}_total") or {}).values())

    clear_static_cache()
    before = dict(link_stat_counts())
    reg_before = {k: series(k) for k in ("nodes", "pairs", "call_sites")}
    link_corpus(proxy_pair(seed=11)).resolve()
    after = link_stat_counts()
    for key in ("nodes", "pairs", "call_sites"):
        assert after[key] > before[key]
        assert series(key) - reg_before[key] == after[key] - before[key]


# ---------------------------------------------------------------------------
# the graph command against the JAX `myth graph`
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    """The JAX graph tests' six-contract directory (proxy pair, minimal
    proxy, cross-call pair), one hex file each."""
    tmp = tmp_path_factory.mktemp("graph")
    for code_hex, _creation, name in FIXTURES["graph_dir"]():
        (tmp / (name.replace("#", "_") + ".hex")).write_text(code_hex)
    return tmp


def _run(*argv):
    out = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def graph_outputs(graph_dir):
    return {
        "port_json": _run("-m", "mythril_tpu_torch", "graph", str(graph_dir), "--json"),
        "jax_json": _run(os.path.join(ROOT, "myth"), "graph", str(graph_dir), "--json"),
        "port_text": _run("-m", "mythril_tpu_torch", "graph", str(graph_dir)),
        "jax_text": _run(os.path.join(ROOT, "myth"), "graph", str(graph_dir)),
    }


def test_graph_json_equals_the_jax_command(graph_outputs):
    port = json.loads(graph_outputs["port_json"])
    assert _no_wall(port) == _no_wall(json.loads(graph_outputs["jax_json"]))
    assert len(port["contracts"]) == 6 and len(port["edges"]) == 3
    assert all(e["resolved"] for e in port["edges"])
    assert {e["provenance"] for e in port["edges"]} == {
        PROV_CONSTANT, PROV_PROXY_SLOT, PROV_MINIMAL_PROXY}
    assert port["stats"]["resolve_rate"] == 1.0 and len(port["proxy_pairs"]) == 2
    assert port["stats"]["wall_ms"] < 1000.0


def test_graph_text_equals_the_jax_command(graph_outputs):
    def lines(text):
        return [line for line in text.splitlines() if "wall:" not in line]

    assert lines(graph_outputs["port_text"]) == lines(graph_outputs["jax_text"])
    for head in ("Link graph:", "proxy-slot", "Proxy pairs:", "Arena co-location plan:"):
        assert head in graph_outputs["port_text"]


def test_graph_refuses_missing_and_empty_inputs(tmp_path, capsys):
    from mythril_tpu_torch.interfaces import cli

    with pytest.raises(SystemExit) as exit_:
        cli.main(["graph", str(tmp_path / "missing")])
    assert exit_.value.code == 2
    (tmp_path / "junk.hex").write_text("zz")
    assert cli.main(["graph", str(tmp_path)]) == 2
    assert "not bytecode hex" in capsys.readouterr().err
