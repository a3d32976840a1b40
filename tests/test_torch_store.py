"""The port's verdict store (mythril_tpu_torch/store) against the JAX package's.

Held live against the JAX package on the CPU, with inputs made from a
seed (corpusgen's generators, numpy-seeded issue rows):

- the store's unit cases (the JAX tests/store/test_store.py): the entry
  lifecycle, key discipline, the corrupt, tampered and mismatched-key
  refusals, concurrent writers, eviction, and entries that vanish under
  a second replica's sweep; each runs on the port;
- entries read across the packages both ways: one package's `put` is the
  other's exact hit (same schema version, key, filename and checksum), and
  `analysis_config_fingerprint` is equal in both for the same arguments;
- `plan_incremental` and `plan_linked_incremental` equal in the changed,
  unchanged and banked sets (and the masks) on the fork and proxy fixtures;
- `analyze_corpus(use_device=False)` over the cold, warm and third store
  runs (chip_smoke.py `store_corpus`): per row the issues, `store_hit`,
  `store_incremental`, the plan's selectors, `link` and `link_run` equal
  the JAX package's live run of the same rows (the JAX
  tests/store/test_store_corpus.py and test_callgraph.py's store
  differential are its cases);
- the service's exact-hit tier at admission (the JAX
  tests/store/test_service_store.py), the analyzer facade's write-back and
  the `analyze`/`serve` flags.

No test races a wall budget: every corpus run walks with an
execution_timeout these contracts cannot reach (STORE_KW: 600 s, the walks
end on their own in about a second each) under deterministic solving, and
the device prepass is off (use_device=False), so a loaded host changes how
long a run takes, never what it finds.

chip_smoke.py's store phase holds the card's runs (use_device on, the
explorer capped at STORE_WAVES waves a phase) to the JAX package's runs of
the same rows and arguments on the CPU, pinned in
tests/test_torch_store_pinned.json with the JAX `myth graph --json`
payloads of the two proxy pairs. Re-pin with

    PYTHONPATH=. python tests/test_torch_store.py --pin-store
"""

import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mythril_tpu_torch.analysis import corpus as port_corpus  # noqa: E402
from mythril_tpu_torch.analysis.corpusgen import (  # noqa: E402
    fork_contract,
    proxy_pair,
)
from mythril_tpu_torch.analysis.static import (  # noqa: E402
    analysis_config_fingerprint,
    clear_static_cache,
    link_corpus,
    summary_for,
)
from mythril_tpu_torch import store as port_store  # noqa: E402
from mythril_tpu_torch.store import (  # noqa: E402
    IncrementalBail,
    SelectorMaskFeed,
    VerdictStore,
    close_stores,
    code_hash_hex,
    merge_banked_issues,
    open_store,
    plan_incremental,
    static_export,
)

torch.set_num_threads(1)

PINNED = chip_smoke.STORE_PIN
BASE = fork_contract(0, 0)
FORK = fork_contract(0, 1)
FP = "a" * 16
#: the fork fixtures the plans are held on: (seed, base variant, fork variant)
FORKS = [(0, 0, 1), (1, 0, 1), (2, 0, 3), (3, 1, 2)]
#: the proxy upgrades the linked plans are held on: (seed, old, new variant)
UPGRADES = [(3, 0, 1), (5, 0, 1), (6, 1, 2)]


@pytest.fixture(autouse=True)
def _fresh_store_cache():
    yield
    close_stores()
    from mythril_tpu.store import close_stores as jax_close_stores

    jax_close_stores()


def _issue(address: int, swc: str = "110") -> dict:
    return {
        "address": address,
        "swc-id": swc,
        "title": "Test issue",
        "contract": "t",
        "function": "f",
        "description": "d",
        "severity": "Medium",
        "min_gas_used": 0,
        "max_gas_used": 1,
        "sourceMap": None,
        "tx_sequence": None,
    }


def _store(tmp_path, **kw) -> VerdictStore:
    return VerdictStore(str(tmp_path / "vstore"), **kw)


# ---------------------------------------------------------------------------
# the store's unit cases (the JAX tests/store/test_store.py), on the port
# ---------------------------------------------------------------------------
def test_put_get_roundtrip(tmp_path):
    store = _store(tmp_path)
    key = code_hash_hex(BASE)
    summary = summary_for(BASE)
    path = store.put(
        key, FP, issues=[_issue(43)], static=static_export(summary),
        provenance={"computed_by": "test", "wall_s": 1.5},
    )
    assert path and os.path.exists(path)
    entry = store.get(key, FP)
    assert entry is not None
    assert entry.issues == [_issue(43)]
    assert entry.fingerprints == summary.function_fingerprints
    assert entry.provenance["computed_by"] == "test"
    assert entry.code_len == summary.code_len
    assert store.stats()["hits"] == 1
    close_stores()
    assert VerdictStore(store.dir).get(key, FP) is not None


def test_miss_is_counted(tmp_path):
    store = _store(tmp_path)
    assert store.get("00" * 32, FP) is None
    assert store.stats()["misses"] == 1


def test_config_fingerprint_distinguishes_module_sets(tmp_path):
    fp_all = analysis_config_fingerprint(modules=None)
    fp_one = analysis_config_fingerprint(modules=["TxOrigin"])
    assert fp_all != fp_one
    store = _store(tmp_path)
    key = code_hash_hex(BASE)
    store.put(key, fp_all, issues=[_issue(43)])
    assert store.get(key, fp_one) is None
    assert store.get(key, fp_all) is not None
    clear_static_cache()
    s_all = summary_for(BASE, config_fp=fp_all)
    s_one = summary_for(BASE, config_fp=fp_one)
    assert s_all is not s_one
    assert summary_for(BASE, config_fp=fp_all) is s_all


def test_config_fingerprint_covers_tx_count_and_version():
    assert analysis_config_fingerprint(transaction_count=1) != analysis_config_fingerprint(
        transaction_count=2)
    assert analysis_config_fingerprint(solver_timeout=1) != analysis_config_fingerprint(
        solver_timeout=2)


def test_corrupt_entry_refused(tmp_path):
    store = _store(tmp_path)
    key = code_hash_hex(BASE)
    path = store.put(key, FP, issues=[_issue(43)])
    with open(path, "w") as fp:
        fp.write("{not json")
    close_stores()
    fresh = VerdictStore(store.dir)
    base_corrupt = fresh.corrupt  # the open-time scan refuses it too
    assert fresh.get(key, FP) is None
    assert fresh.corrupt > 0 and fresh.corrupt >= base_corrupt
    assert fresh.stats()["misses"] >= 1


def test_tampered_payload_refused(tmp_path):
    store = _store(tmp_path)
    key = code_hash_hex(BASE)
    path = store.put(key, FP, issues=[_issue(43)])
    with open(path) as fp:
        data = json.load(fp)
    data["issues"] = []  # verdict swapped, checksum now stale
    with open(path, "w") as fp:
        json.dump(data, fp)
    assert store.get(key, FP) is None
    assert store.corrupt >= 1


def test_mismatched_key_refused(tmp_path):
    store = _store(tmp_path)
    key_a, key_b = code_hash_hex(BASE), code_hash_hex(FORK)
    path_a = store.put(key_a, FP, issues=[_issue(43)])
    path_b = store.put(key_b, FP, issues=[_issue(56)])
    with open(path_a) as fp:
        blob = fp.read()
    with open(path_b, "w") as fp:
        fp.write(blob)
    assert store.get(key_b, FP) is None
    assert store.corrupt >= 1


def test_concurrent_writers_never_corrupt(tmp_path):
    store = _store(tmp_path)
    errors = []

    def writer(k: int) -> None:
        try:
            for i in range(8):
                key = code_hash_hex(f"{'00' if k % 2 else '11'}")
                store.put(key, FP, issues=[_issue(i)], provenance={"writer": k, "round": i})
        except Exception as why:  # pragma: no cover
            errors.append(why)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    close_stores()
    fresh = VerdictStore(store.dir)
    assert fresh.corrupt == 0
    assert fresh.get(code_hash_hex("00"), FP) is not None
    assert fresh.get(code_hash_hex("11"), FP) is not None


def test_eviction_bounds_entries(tmp_path):
    store = _store(tmp_path, capacity=2)
    for i in range(5):
        store.put(code_hash_hex(f"{i:02x}"), FP, issues=[])
    assert len(store) <= 2
    assert store.stats()["evictions"] >= 3


def _entry_for(store, code_hex: str, issues):
    key = code_hash_hex(code_hex)
    store.put(key, FP, issues=issues, static=static_export(summary_for(code_hex)))
    return store.get(key, FP)


def test_plan_masks_only_unchanged_selector(tmp_path):
    from mythril_tpu_torch.laser.batch.seeds import dispatcher_seeds

    store = _store(tmp_path)
    entry = _entry_for(store, BASE, [_issue(43), _issue(56)])
    plan = plan_incremental(summary_for(FORK), entry)
    assert plan.changed == {"0xf0cacc1a"}
    assert plan.unchanged == {"0xba5eba11"}
    assert plan.mask_selectors == {bytes.fromhex("ba5eba11")}
    assert [i["address"] for i in plan.banked_issues] == [56]
    feed = plan.mask_feed(summary_for(FORK))
    seeds = dispatcher_seeds(FORK, 68, prune=feed)
    assert feed.seeds_dropped == 2
    assert not any(s.startswith(bytes.fromhex("ba5eba11")) for s in seeds)
    assert any(s.startswith(bytes.fromhex("f0cacc1a")) for s in seeds)


def test_plan_bails_without_fingerprints(tmp_path):
    store = _store(tmp_path)
    key = code_hash_hex(BASE)
    store.put(key, FP, issues=[_issue(43)])  # no static export
    with pytest.raises(IncrementalBail) as raised:
        plan_incremental(summary_for(FORK), store.get(key, FP))
    assert raised.value.reason == "fingerprints-absent"


def _sload_fork_pair():
    """fork_contract(3, *) with fn B's CALLDATALOAD(4) patched to an SLOAD:
    a changed fn A (SSTORE) can then alter what unchanged fn B reads."""
    patch, sload, fn_b = bytes.fromhex("600435"), bytes.fromhex("600054"), 44
    base = bytes.fromhex(fork_contract(3, 0))
    fork = bytes.fromhex(fork_contract(3, 1))
    assert base[fn_b + 1: fn_b + 4] == patch
    return (base[: fn_b + 1] + sload + base[fn_b + 4:]).hex(), (
        fork[: fn_b + 1] + sload + fork[fn_b + 4:]).hex()


def test_plan_bails_on_cross_selector_state_flow(tmp_path):
    base, fork = _sload_fork_pair()
    entry = _entry_for(_store(tmp_path), base, [_issue(43)])
    with pytest.raises(IncrementalBail) as raised:
        plan_incremental(summary_for(fork), entry)
    assert raised.value.reason == "cross-selector-state-flow"


def test_merge_banked_issues_dedupes():
    issues = [_issue(56)]
    assert merge_banked_issues(issues, [_issue(56), _issue(99)]) == 1
    assert [i["address"] for i in issues] == [56, 99]


def test_mask_feed_delegates():
    summary = summary_for(BASE)
    feed = SelectorMaskFeed(summary, set(), set())
    assert feed.features == summary.features
    assert feed.code_hash == summary.code_hash
    assert feed.prune_directions() == summary.prune_directions()


def test_second_replica_instance_reads_and_evicts_same_directory(tmp_path):
    a = _store(tmp_path)
    b = VerdictStore(a.dir)
    a.put(code_hash_hex("aa"), FP, issues=[_issue(1)])
    assert b.get(code_hash_hex("aa"), FP) is not None
    os.unlink(os.path.join(a.entries_dir, os.listdir(a.entries_dir)[0]))
    before_corrupt = a.corrupt
    assert a.get(code_hash_hex("aa"), FP) is None
    assert a.corrupt == before_corrupt  # vanished, not corrupt


def test_evict_tolerates_entries_vanishing_mid_sweep(tmp_path, monkeypatch):
    store = _store(tmp_path, capacity=2)
    for i in range(4):
        store.put(code_hash_hex(f"{i:02x}"), FP, issues=[])
    victim = sorted(n for n in os.listdir(store.entries_dir) if n.endswith(".json"))[0]
    real_getmtime = os.path.getmtime

    def racy_getmtime(path):
        if os.path.basename(path) == victim:
            raise FileNotFoundError(path)
        return real_getmtime(path)

    monkeypatch.setattr(os.path, "getmtime", racy_getmtime)
    store.put(code_hash_hex("fe"), FP, issues=[])  # triggers _evict
    assert len(store) <= 3


def test_scan_tolerates_entries_vanishing_mid_open(tmp_path, monkeypatch):
    seed = _store(tmp_path)
    for i in range(3):
        seed.put(code_hash_hex(f"{i:02x}"), FP, issues=[])
    names = sorted(n for n in os.listdir(seed.entries_dir) if n.endswith(".json"))
    victim = os.path.join(seed.entries_dir, names[0])
    real_open = open

    def racy_open(path, *args, **kwargs):
        if path == victim:
            raise FileNotFoundError(path)
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr("builtins.open", racy_open)
    fresh = VerdictStore(seed.dir)
    assert fresh.corrupt == 0
    monkeypatch.undo()
    assert fresh.get(code_hash_hex("01"), FP) is not None


def test_get_tolerates_entry_vanishing_after_exists_check(tmp_path, monkeypatch):
    store = _store(tmp_path)
    key = code_hash_hex("ab")
    store.put(key, FP, issues=[_issue(2)])
    monkeypatch.setattr(os.path, "exists", lambda path: True)
    os.unlink(os.path.join(store.entries_dir, os.listdir(store.entries_dir)[0]))
    before = (store.corrupt, store.misses)
    assert store.get(key, FP) is None
    assert store.corrupt == before[0]
    assert store.misses == before[1] + 1


# ---------------------------------------------------------------------------
# the port's departures: failures recorded, not only logged
# ---------------------------------------------------------------------------
def test_failed_write_is_recorded_and_returns_none(tmp_path):
    from mythril_tpu_torch.support import resilience

    store = _store(tmp_path)
    marker = resilience.DegradationLog().marker()
    resilience.arm_fault("store.write", action="raise")
    try:
        assert store.put(code_hash_hex(BASE), FP, issues=[_issue(43)]) is None
    finally:
        resilience.disarm_faults()
    assert resilience.DegradationLog().counts_since(marker) == {
        "store-writeback-failed": 1}
    assert len(store) == 0


def test_failed_read_and_open_are_recorded(tmp_path):
    from mythril_tpu_torch.support import resilience

    store = _store(tmp_path)
    store.put(code_hash_hex(BASE), FP, issues=[_issue(43)])
    marker = resilience.DegradationLog().marker()
    resilience.arm_fault("store.read", action="raise")
    try:
        assert store.get(code_hash_hex(BASE), FP) is None
    finally:
        resilience.disarm_faults()
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert open_store(str(blocked / "store")) is None  # a file where a dir must go
    assert resilience.DegradationLog().counts_since(marker) == {"store-unavailable": 2}


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
FP_ARGS = [
    {},
    {"modules": ["TxOrigin"]},
    {"transaction_count": 1},
    {"transaction_count": 2, "create_timeout": 10},
    {"solver_timeout": 4000, "transaction_count": 3},
    {"modules": ["AccidentallyKillable", "Exceptions"], "create_timeout": 30},
]


#: the flag-bag fields the fingerprint reads, set alike in both packages
FP_FLAGS = [
    {"static_prune": True, "static_answer": True, "solver_timeout": 10_000},
    {"static_prune": True, "static_answer": False, "solver_timeout": 2_000},
    {"static_prune": False, "static_answer": True, "solver_timeout": 10_000},
]


@pytest.mark.parametrize("flags", FP_FLAGS, ids=["defaults", "no-answer", "no-prune"])
@pytest.mark.parametrize("kw", FP_ARGS, ids=lambda kw: ",".join(sorted(kw)) or "no-args")
def test_config_fingerprint_equals_the_jax_one(kw, flags, monkeypatch):
    """The same arguments under the same flags hash alike in both
    packages (both are version 0.1.0), so each reads the other's entries."""
    from mythril_tpu import __version__ as jax_version
    from mythril_tpu.analysis.static import summary as jax_summary
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch import __version__
    from mythril_tpu_torch.support.support_args import args as port_args

    assert __version__ == jax_version
    for bag in (jax_args, port_args):
        for flag, value in flags.items():
            monkeypatch.setattr(bag, flag, value)
    assert analysis_config_fingerprint(**kw) == jax_summary.analysis_config_fingerprint(**kw)


def _seeded_issues(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    return [_issue(int(a), str(s)) for a, s in zip(rng.integers(0, 200, n),
                                                     rng.choice([104, 106, 110], n))]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_an_entry_one_package_writes_is_the_others_hit(tmp_path, writer, seed):
    """A `put` of one package is an exact hit of the other (same key,
    filename, schema and checksum), with the issues, fingerprints, spans
    and code length intact; entries of the same payload are byte-equal
    apart from the provenance each writer stamps."""
    from mythril_tpu import store as jax_store
    from mythril_tpu.analysis.static import summary_for as jax_summary_for

    code = fork_contract(seed, 0)
    issues = _seeded_issues(seed)
    directory = str(tmp_path / "vstore")
    pkgs = {"port": (port_store, summary_for), "jax": (jax_store, jax_summary_for)}
    w_store, w_summary = pkgs[writer]
    r_store, _ = pkgs["jax" if writer == "port" else "port"]
    key = w_store.code_hash_hex(code)
    assert key == r_store.code_hash_hex(code)
    path = w_store.open_store(directory).put(
        key, FP, issues=issues, static=w_store.static_export(w_summary(code)),
        provenance={"computed_by": writer})
    entry = r_store.open_store(directory).get(key, FP)
    assert entry is not None and entry.path == path
    assert entry.issues == issues
    assert entry.fingerprints == summary_for(code).function_fingerprints
    assert entry.selector_spans == {
        sel: [list(s) for s in spans] for sel, spans in summary_for(code).selector_subgraphs().items()}
    assert entry.provenance["computed_by"] == writer
    assert r_store.open_store(directory).stats()["corrupt"] == 0


def test_static_exports_equal_the_jax_ones():
    """`static_export` (with the corpus LinkSet: the linked fingerprints
    and the link block) and `banks_from_outcome` give the JAX payloads."""
    from mythril_tpu import store as jax_store
    from mythril_tpu.analysis.static import link_corpus as jax_link_corpus
    from mythril_tpu.analysis.static import summary_for as jax_summary_for

    rows = proxy_pair(seed=5) + [(fork_contract(2, 0), "", "f")]
    port_links, jax_links = link_corpus(rows), jax_link_corpus(rows)
    for code, _, _ in rows:
        assert static_export(summary_for(code), linkset=port_links) == jax_store.static_export(
            jax_summary_for(code), linkset=jax_links)
    outcome = {"covered_branches": [(12, True), (12, False), (40, True)],
               "triggers": {"selfdestruct": [{"pc": 15, "calldata": "42"}]}}
    assert port_store.banks_from_outcome(outcome) == jax_store.banks_from_outcome(outcome)


# ---------------------------------------------------------------------------
# incremental plans against the JAX planner
# ---------------------------------------------------------------------------
def _plan_view(plan):
    if plan is None:
        return None
    return {"changed": sorted(plan.changed), "unchanged": sorted(plan.unchanged),
            "mask_selectors": sorted(plan.mask_selectors),
            "mask_directions": sorted(plan.mask_directions),
            "banked": plan.banked_issues, "injected": plan.injected_outcome,
            "as_dict": plan.as_dict()}


def _plan_or_bail(plan_fn, *args):
    """The plan's view, or ("bail", reason) for either package's
    IncrementalBail."""
    try:
        return _plan_view(plan_fn(*args))
    except Exception as why:
        return ("bail", getattr(why, "reason", repr(why)))


@pytest.mark.parametrize("seed,old,new", FORKS)
def test_plan_incremental_equals_the_jax_plan(tmp_path, seed, old, new):
    from mythril_tpu import store as jax_store
    from mythril_tpu.analysis.static import summary_for as jax_summary_for

    base, fork = fork_contract(seed, old), fork_contract(seed, new)
    banks = {"covered": [[12, True], [30, False], [50, True]],
             "triggers": {"assert": [{"pc": 43}, {"pc": 56}]}}
    port_s = open_store(str(tmp_path / "p"))
    jax_s = jax_store.open_store(str(tmp_path / "j"))
    issues = [_issue(43), _issue(56), _issue(2)]
    key = code_hash_hex(base)
    port_s.put(key, FP, issues=issues, static=static_export(summary_for(base)), banks=banks)
    jax_s.put(key, FP, issues=issues, static=jax_store.static_export(jax_summary_for(base)),
              banks=banks)
    port = _plan_or_bail(plan_incremental, summary_for(fork), port_s.get(key, FP))
    jax = _plan_or_bail(jax_store.plan_incremental, jax_summary_for(fork), jax_s.get(key, FP))
    assert port == jax
    assert isinstance(port, dict) and port["changed"] and port["unchanged"]


def test_plan_bail_on_state_flow_equals_the_jax_bail(tmp_path):
    from mythril_tpu import store as jax_store
    from mythril_tpu.analysis.static import summary_for as jax_summary_for

    base, fork = _sload_fork_pair()
    port_s, jax_s = open_store(str(tmp_path / "p")), jax_store.open_store(str(tmp_path / "j"))
    key = code_hash_hex(base)
    port_s.put(key, FP, issues=[_issue(43)], static=static_export(summary_for(base)))
    jax_s.put(key, FP, issues=[_issue(43)],
              static=jax_store.static_export(jax_summary_for(base)))
    port = _plan_or_bail(plan_incremental, summary_for(fork), port_s.get(key, FP))
    jax = _plan_or_bail(jax_store.plan_incremental, jax_summary_for(fork), jax_s.get(key, FP))
    assert port == jax == ("bail", "cross-selector-state-flow")


@pytest.mark.parametrize("seed,old,new", UPGRADES)
def test_plan_linked_incremental_equals_the_jax_plan(tmp_path, seed, old, new):
    """The proxy's bytes are unchanged and its callee moved: the linked
    plan re-runs only the forwarding selector, in both packages."""
    from mythril_tpu import store as jax_store
    from mythril_tpu.analysis.static import link_corpus as jax_link_corpus
    from mythril_tpu.analysis.static import summary_for as jax_summary_for

    before, after = proxy_pair(seed=seed, variant=old), proxy_pair(seed=seed, variant=new)
    proxy = before[0][0]
    assert after[0][0] == proxy
    key = code_hash_hex(proxy)
    views = []
    for pkg, link, summ, where in (
            (port_store, link_corpus, summary_for, "p"),
            (jax_store, jax_link_corpus, jax_summary_for, "j")):
        vstore = pkg.open_store(str(tmp_path / where))
        vstore.put(key, FP, issues=[_issue(144), _issue(69, "112")],
                   static=pkg.static_export(summ(proxy), linkset=link(before)))
        now = link(after)
        linked, problems = now.linked_fingerprints("0x" + key)
        views.append(_plan_or_bail(pkg.plan_linked_incremental, summ(proxy),
                                   vstore.get(key, FP), linked, problems))
    port, jax = views
    assert port == jax
    assert port["changed"] == [f"0x{(0xCA11AB1E + seed) & 0xFFFFFFFF:08x}"]
    assert "0x3659cfe6" in port["unchanged"] and port["as_dict"]["linked"] is True


# ---------------------------------------------------------------------------
# analyze_corpus: the cold, warm and third runs against the JAX package's
# ---------------------------------------------------------------------------
#: the host-only runs' arguments: no device, a walk budget the walks cannot
#: reach, deterministic solving (chip_smoke.STORE_KW, use_device off)
HOST_KW = dict(chip_smoke.STORE_KW, use_device=False)


def _host_flags(setattr_):
    """Both packages at their analyze defaults for the store runs: the
    static pass, the static answer and the store tier on."""
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support.support_args import args as port_args

    for bag in (jax_args, port_args):
        for flag, value in (("static_prune", True), ("static_answer", True), ("store", True),
                            ("store_dir", None)):
            setattr_(bag, flag, value)


def _runs(analyze, store_dir, **kw):
    out = {}
    for name, rows in chip_smoke.store_corpus().items():
        out[name] = analyze(rows, store_dir=store_dir, **dict(HOST_KW, **kw))
    return out


@pytest.fixture(scope="module")
def store_runs(tmp_path_factory):
    """The port's and the JAX package's host-only cold, warm and third
    runs, each package into a fresh store of its own."""
    from mythril_tpu.analysis import corpus as jax_corpus

    with pytest.MonkeyPatch.context() as mp:
        _host_flags(mp.setattr)
        port = _runs(port_corpus.analyze_corpus, str(tmp_path_factory.mktemp("port")))
        jax = _runs(jax_corpus.analyze_corpus, str(tmp_path_factory.mktemp("jax")),
                    processes=1, router=False)
    close_stores()
    return port, jax


@pytest.mark.parametrize("run", ["cold", "warm", "third"])
def test_store_runs_equal_the_jax_runs(store_runs, run):
    port, jax = store_runs
    assert chip_smoke.store_summary(port[run]) == chip_smoke.store_summary(jax[run])
    assert all(r["complete"] for r in port[run])


def test_store_runs_take_every_tier(store_runs):
    """What the runs exercise: the cold run banks every row; the warm run
    settles the bases as exact hits, plans the fork against base0 and the
    proxy against its moved callee (linked), and analyzes the new rows in
    full; the third run settles every row as an exact hit."""
    port, _ = store_runs
    summary = {run: {row[0]: row[1:5] for row in chip_smoke.store_summary(res)}
               for run, res in port.items()}
    assert not any(hit or inc for hit, inc, *_ in summary["cold"].values())
    warm = summary["warm"]
    assert [name for name, (hit, *_) in warm.items() if hit] == [
        "base0", "base1", "deadweight"]
    assert warm["fork0"] == [False, True, ["0xf0cacc1a"], ["0xba5eba11"]]
    assert warm["proxy#5"][:3] == [False, True, ["0xca11ab23"]]
    assert [r["store"]["linked"] for r in port["warm"] if r["name"] == "proxy#5"] == [True]
    assert all(hit for hit, *_ in summary["third"].values())
    assert all(r["states"] == 0 for r in port["third"])


def test_store_hits_rebuild_their_issue_objects(store_runs):
    port, _ = store_runs
    for result in port["third"]:
        assert [i.as_dict for i in result["issue_objects"]] == result["issues"]


def test_incremental_issues_equal_a_cold_full_run(store_runs):
    """THE differential of the JAX suites: the incremental fork and the
    linked proxy report the issues a cold full run of the same code does."""
    port, _ = store_runs
    warm = {r["name"]: r for r in port["warm"]}
    cold = port_corpus.analyze_corpus(
        [(fork_contract(0, 1), "", "fork0"), proxy_pair(seed=5, variant=1)[0]], store=False,
        **HOST_KW)
    for result in cold:
        assert sorted((i["address"], i["swc-id"]) for i in warm[result["name"]]["issues"]) == \
            sorted((i["address"], i["swc-id"]) for i in result["issues"])


def test_a_store_one_package_banks_answers_the_other(tmp_path):
    """The JAX package's cold run banks the corpus; the port's warm run
    reads its entries as exact hits and plans the fork against them, and
    the other way round."""
    from mythril_tpu.analysis import corpus as jax_corpus

    runs = chip_smoke.store_corpus()
    with pytest.MonkeyPatch.context() as mp:
        _host_flags(mp.setattr)
        for writer, reader in ((jax_corpus.analyze_corpus, port_corpus.analyze_corpus),
                               (port_corpus.analyze_corpus, jax_corpus.analyze_corpus)):
            directory = str(tmp_path / writer.__module__)
            extra = {"processes": 1, "router": False}
            writer(runs["cold"][:3], store_dir=directory,
                   **dict(HOST_KW, **(extra if writer is jax_corpus.analyze_corpus else {})))
            close_stores()
            got = reader(runs["warm"][:4], store_dir=directory,
                         **dict(HOST_KW, **(extra if reader is jax_corpus.analyze_corpus else {})))
            assert [bool(r.get("store_hit")) for r in got] == [True, True, True, False]
            assert got[3]["store_incremental"] is True


def test_no_store_parity(tmp_path):
    """--no-store: the same issues, no store flags, nothing written."""
    rows = [(BASE, "", "base")]
    store_dir = str(tmp_path / "vstore")
    first = port_corpus.analyze_corpus(rows, store_dir=store_dir, **HOST_KW)[0]
    repeat = port_corpus.analyze_corpus(rows, store_dir=store_dir, store=False, **HOST_KW)[0]
    assert not repeat.get("store_hit") and not repeat.get("store_incremental")
    assert repeat["issues"] == first["issues"]
    from mythril_tpu_torch.support.support_args import args

    previous = args.store
    args.store = False
    try:
        flagged = port_corpus.analyze_corpus(rows, store_dir=store_dir, **HOST_KW)[0]
    finally:
        args.store = previous
    assert not flagged.get("store_hit")
    assert len(open_store(store_dir)) == 1


def test_incremental_bail_falls_back_to_full(tmp_path):
    """An entry with fingerprints but no selector spans cannot be diffed:
    the fork takes the full path with the same issues."""
    store_dir = str(tmp_path / "vstore")
    config_fp = analysis_config_fingerprint(transaction_count=2, create_timeout=10)
    open_store(store_dir).put(
        code_hash_hex(BASE), config_fp, issues=[{"address": 1, "swc-id": "110"}],
        static={"code_len": 57,
                "function_fingerprints": dict(summary_for(BASE).function_fingerprints)})
    result = port_corpus.analyze_corpus([(FORK, "", "fork")], store_dir=store_dir,
                                        **HOST_KW)[0]
    cold = port_corpus.analyze_corpus([(FORK, "", "fork")], store=False, **HOST_KW)[0]
    assert not result.get("store_incremental")
    assert sorted((i["address"], i["swc-id"]) for i in result["issues"]) == sorted(
        (i["address"], i["swc-id"]) for i in cold["issues"])


def test_writeback_skips_incomplete(tmp_path):
    store_dir = str(tmp_path / "vstore")
    results = port_corpus.analyze_corpus([(BASE, "", "base")], store_dir=store_dir,
                                         deadline_s=0.000001, **HOST_KW)
    assert results[0].get("skipped")
    assert len(open_store(store_dir)) == 0


def test_failed_writeback_is_recorded_and_the_analysis_stands(tmp_path):
    from mythril_tpu_torch.support import resilience

    marker = resilience.DegradationLog().marker()
    resilience.arm_fault("store.write", action="raise")
    try:
        (result,) = port_corpus.analyze_corpus([(BASE, "", "base")],
                                               store_dir=str(tmp_path / "v"), **HOST_KW)
    finally:
        resilience.disarm_faults()
    assert result["complete"] and result["issues"]
    assert resilience.DegradationLog().counts_since(marker) == {"store-writeback-failed": 1}


def test_masks_reach_the_explorer(monkeypatch):
    """The plans' selector masks reach DeviceCorpusExplorer through
    corpus_device_prepass, translated to track indices (rows the prepass
    cannot run are not tracks)."""
    from mythril_tpu_torch.laser.batch import explore

    seen = {}

    class Stop(Exception):
        pass

    class Recording(explore.DeviceCorpusExplorer):
        def __init__(self, codes, **kw):
            seen["masks"] = kw.get("selector_masks")
            raise Stop

    monkeypatch.setattr(explore, "DeviceCorpusExplorer", Recording)
    mask = ({bytes.fromhex("ba5eba11")}, {(35, True)})
    with pytest.raises(Stop):
        port_corpus.corpus_device_prepass(
            [("", "", "settled"), (FORK, "", "fork")], selector_masks={1: mask}, device="cpu")
    assert seen["masks"] == {0: mask}


def test_masked_prepass_drops_the_unchanged_seeds(tmp_path, monkeypatch):
    """With the device axis on the CPU (the explorer narrowed to 4 lanes a
    contract and lean caps, so that the CPU runs it in seconds), the warm
    fork's prepass runs masked: the explorer counts the unchanged selector
    it masked, and the fork's issues are the cold run's."""
    from mythril_tpu_torch.laser.batch import explore

    base = explore.DeviceCorpusExplorer

    class Narrow(base):
        def __init__(self, codes, **kw):
            super().__init__(codes, **dict(kw, lanes_per_contract=4, mem_cap=1024,
                                           storage_cap=16, steps_per_wave=128))

    monkeypatch.setattr(explore, "DeviceCorpusExplorer", Narrow)
    # the enumeration-only device solver: the plain SLS of 256-bit flips
    # takes minutes on the CPU
    from mythril_tpu_torch.laser.smt.solver import portfolio
    from test_torch_explore import enum_only_solver

    monkeypatch.setattr(portfolio, "device_solve_batch",
                        enum_only_solver(portfolio, device="cpu"))
    store_dir = str(tmp_path / "vstore")
    kw = dict(chip_smoke.STORE_KW, waves=2, device_budget_s=float("inf"), device="cpu")
    port_corpus.analyze_corpus([(BASE, "", "base0")], store_dir=store_dir, **kw)
    (fork,) = port_corpus.analyze_corpus([(FORK, "", "fork0")], store_dir=store_dir, **kw)
    assert fork["store_incremental"] is True
    assert fork["device_prepass"]["store_masked_selectors"] == 1
    assert sorted((i["address"], i["swc-id"]) for i in fork["issues"]) == [(43, "110"),
                                                                           (56, "110")]


# ---------------------------------------------------------------------------
# the service's exact-hit tier (the JAX tests/store/test_service_store.py)
# ---------------------------------------------------------------------------
SERVICE_CFG = dict(stripes=2, lanes_per_stripe=4, steps_per_wave=64, queue_capacity=4,
                   host_walk=False, device="cpu")
BANKED = fork_contract(7, 0)
UNSEEN = "33ff"


@pytest.fixture()
def seeded_store(tmp_path):
    """A store seeded by the JAX package with BANKED's verdict under the
    fingerprint the port's engine computes for SERVICE_CFG."""
    from mythril_tpu import store as jax_store
    from mythril_tpu_torch.service.engine import ServiceConfig

    directory = str(tmp_path / "vstore")
    cfg = ServiceConfig(**SERVICE_CFG)
    fingerprint = analysis_config_fingerprint(transaction_count=cfg.transaction_count,
                                              create_timeout=cfg.create_timeout)
    jax_store.open_store(directory).put(
        jax_store.code_hash_hex(BANKED), fingerprint, issues=[_issue(43)],
        provenance={"computed_by": "test-seeder", "wall_s": 12.0})
    return directory


@pytest.fixture()
def store_server(seeded_store):
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    srv = AnalysisServer(ServiceConfig(store_dir=seeded_store, **SERVICE_CFG),
                         start_engine=False).start()
    yield srv
    srv.close()


def test_repeat_submission_settles_at_admission(store_server):
    from mythril_tpu_torch.service.client import ServiceClient

    client = ServiceClient(store_server.url, honor_retry_after=False)
    job = client.job(client.submit(BANKED))
    assert job["state"] == "done"
    report = job["report"]
    assert report["store_hit"] is True and report["issues"] == [_issue(43)]
    assert report["store"]["provenance"]["computed_by"] == "test-seeder"
    assert "device" not in report
    stats = client.stats()
    assert stats["store"]["enabled"] is True
    assert stats["store"]["answered"] == 1 and stats["store"]["hits"] == 1
    assert stats["waves"]["count"] == 0
    assert stats["queue"]["jobs"].get("done") == 1


def test_unseen_code_queues_normally(store_server):
    from mythril_tpu_torch.service.client import ServiceClient

    client = ServiceClient(store_server.url, honor_retry_after=False)
    assert client.job(client.submit(UNSEEN))["state"] == "queued"
    stats = client.stats()
    assert stats["store"]["answered"] == 0 and stats["store"]["misses"] >= 1


def test_hit_skips_full_queue_backpressure(store_server):
    from mythril_tpu_torch.service.client import ServiceClient, ServiceError

    client = ServiceClient(store_server.url, honor_retry_after=False)
    for _ in range(SERVICE_CFG["queue_capacity"]):
        client.submit(UNSEEN)
    with pytest.raises(ServiceError):
        client.submit(UNSEEN)  # 429: the queue is full
    assert client.job(client.submit(BANKED))["state"] == "done"


def test_no_store_config_disables_tier(seeded_store):
    from mythril_tpu_torch.service.client import ServiceClient
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    srv = AnalysisServer(ServiceConfig(store_dir=seeded_store, store=False, **SERVICE_CFG),
                         start_engine=False).start()
    try:
        client = ServiceClient(srv.url, honor_retry_after=False)
        assert client.job(client.submit(BANKED))["state"] == "queued"
        stats = client.stats()
        assert stats["store"]["enabled"] is False and stats["store"]["answered"] == 0
    finally:
        srv.close()


def test_draining_refuses_store_hits(seeded_store):
    from mythril_tpu_torch.service.client import ServiceClient, ServiceError
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    srv = AnalysisServer(ServiceConfig(store_dir=seeded_store, **SERVICE_CFG),
                         start_engine=False).start()
    try:
        client = ServiceClient(srv.url, honor_retry_after=False)
        srv.engine.drain(timeout_s=5.0)
        with pytest.raises(ServiceError):
            client.submit(BANKED)  # 503: draining
    finally:
        srv.close()


def test_completed_walk_writes_back_and_the_repeat_is_a_hit(tmp_path):
    """A job whose walk completes banks its verdict (the JAX package reads
    it as a hit); the same code submitted again settles at admission with
    no further wave."""
    from mythril_tpu import store as jax_store
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu_torch.service.jobs import Job

    directory = str(tmp_path / "vstore")
    engine = AnalysisEngine(ServiceConfig(
        store_dir=directory, **dict(SERVICE_CFG, host_walk=True, max_waves=1,
                                    execution_timeout=60))).start()
    try:
        first = engine.queue.wait_terminal(engine.submit(Job(UNSEEN)).id, 120)
        assert first is not None and first.state == "done", first and first.error
        # the write-back follows the settle on the loop thread
        deadline = time.monotonic() + 30
        while engine.stats()["store"]["writebacks"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        waves = engine.stats()["waves"]["count"]
        assert engine.stats()["store"]["writebacks"] == 1
        second = engine.submit(Job(UNSEEN))
        assert second.state == "done" and second.report["store_hit"] is True
        assert second.report["issues"] == first.report["issues"]
        assert engine.stats()["waves"]["count"] == waves
    finally:
        engine.drain(timeout_s=10.0)
    fingerprint = analysis_config_fingerprint(transaction_count=2, create_timeout=10)
    entry = jax_store.open_store(directory).get(jax_store.code_hash_hex(UNSEEN), fingerprint)
    assert entry is not None and entry.issues == first.report["issues"]


# ---------------------------------------------------------------------------
# the analyzer facade's write-back and the command line
# ---------------------------------------------------------------------------
def test_facade_banks_a_completed_contract(tmp_path):
    """`MythrilAnalyzer(store_dir=)`: a cleanly completed runtime contract
    banks its verdict under the facade's fingerprint; the JAX store reads
    it as a hit."""
    from mythril_tpu import store as jax_store
    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.support.support_args import args

    saved = dict(vars(args))
    directory = str(tmp_path / "vstore")
    try:
        disassembler = MythrilDisassembler()
        address, _ = disassembler.load_from_bytecode(BASE, bin_runtime=True)
        report = MythrilAnalyzer(
            disassembler, device="cpu", address=address, store_dir=directory,
            execution_timeout=60, max_depth=128, loop_bound=3, create_timeout=10,
            device_prepass="never", device_solving="never",
        ).fire_lasers(transaction_count=2)
    finally:
        vars(args).update(saved)
    assert not report.exceptions
    fingerprint = analysis_config_fingerprint(transaction_count=2, create_timeout=10)
    entry = jax_store.open_store(directory).get(jax_store.code_hash_hex(BASE), fingerprint)
    assert entry is not None
    assert sorted(i["address"] for i in entry.issues) == sorted(
        i.address for i in report.issues.values())
    assert entry.provenance["computed_by"] == "analyzer"


@pytest.mark.parametrize("argv,env,want", [
    (["--store", "S"], {}, ("S", True)),
    ([], {"MYTHRIL_STORE_DIR": "E"}, ("E", True)),
    (["--store", "S", "--no-store"], {}, ("S", False)),
    ([], {}, (None, True)),
])
def test_serve_passes_the_store_settings(argv, env, want, monkeypatch):
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.service import server

    monkeypatch.delenv("MYTHRIL_STORE_DIR", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    seen = {}
    monkeypatch.setattr(server, "serve_forever",
                        lambda config, **_kw: seen.update(cfg=config))
    assert cli.main(["serve", "--device", "cpu", *argv]) == 0
    assert (seen["cfg"].store_dir, seen["cfg"].store) == want


def test_analyze_store_flag_banks_the_run(tmp_path, capsys):
    """`analyze --store DIR` through the command line writes the verdict
    (the flag bag restored after the run)."""
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
    from mythril_tpu_torch.support.support_args import args

    saved, actors = dict(vars(args)), dict(vars(ACTORS))
    directory = str(tmp_path / "vstore")
    try:
        assert cli.main(["analyze", "--bin-runtime", "-c", BASE, "-o", "json", "--device",
                         "cpu", "--store", directory, "--no-onchain-data",
                         "--device-prepass", "never", "--device-solving", "never",
                         "-t", "2", "--execution-timeout", "60"]) == 0
    finally:
        vars(args).update(saved)
        vars(ACTORS).update(actors)
    assert json.loads(capsys.readouterr().out)["success"] is True
    assert len(open_store(directory)) == 1


# ---------------------------------------------------------------------------
# the pin chip_smoke.py's store phase reads
# ---------------------------------------------------------------------------
def test_pin_matches_the_corpus_and_graphs():
    """The pin was taken on the rows and arguments chip_smoke.py runs; the
    port's LinkSet payloads equal its JAX `myth graph --json` ones (the
    command's own output: tests/test_torch_linkset.py)."""
    doc = json.loads(PINNED.read_text())
    runs = chip_smoke.store_corpus()
    assert doc["settings"]["waves"] == chip_smoke.STORE_WAVES
    assert doc["settings"]["kw"] == chip_smoke.STORE_KW
    assert doc["rows"] == {name: [[hashlib.sha256(bytes.fromhex(c)).hexdigest(), n]
                                  for c, _, n in rows] for name, rows in runs.items()}
    for variant in (0, 1):
        # named as `graph DIR` names the pin's files
        rows = [(c, "", n.replace("#", "_")) for c, _, n in proxy_pair(seed=5, variant=variant)]
        payload = link_corpus(rows).as_dict()
        assert chip_smoke.graph_payload(payload) == doc["graph"][f"proxy_pair_5_{variant}"]


def pin_store() -> None:
    """The JAX side of chip_smoke.py's store phase: the JAX analyze_corpus
    on store_corpus()'s three runs into one fresh store, with the device
    axis on (the JAX prepass on its CPU devices), prepass first
    (`_effective_cpus` 1), its explorer capped at STORE_WAVES waves a
    phase with no wall budget, STORE_KW's arguments, the static pass, the
    static answer and the store on, specialization and blockjit off (the
    suite's settings; the issues do not depend on them), the
    enumeration-only device solver (tests/test_torch_explore.py); and the
    JAX `myth graph --json` payloads of the two proxy pairs."""
    import subprocess
    import tempfile
    import time

    import conftest  # noqa: F401  (the suite's JAX settings)
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.laser.batch import explore as jax_explore
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.support.support_args import args as jax_args
    from test_torch_explore import enum_only_solver

    runs = chip_smoke.store_corpus()
    doc = {"settings": {"waves": chip_smoke.STORE_WAVES, "kw": chip_smoke.STORE_KW,
                        "use_device": True, "schedule": "prepass first",
                        "solver": "enumeration only", "static_prune": True,
                        "static_answer": True, "specialize": False, "blockjit": False},
           "rows": {name: [[hashlib.sha256(bytes.fromhex(c)).hexdigest(), n]
                           for c, _, n in rows] for name, rows in runs.items()},
           "runs": {}, "graph": {}}
    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as store_dir:
        for flag, value in (("static_prune", True), ("static_answer", True),
                            ("specialize", False), ("blockjit", False), ("store", True),
                            ("device_first", True)):
            mp.setattr(jax_args, flag, value)
        base = jax_explore.DeviceCorpusExplorer

        class Capped(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **dict(kw, waves=chip_smoke.STORE_WAVES, budget_s=None))

        mp.setattr(jax_explore, "DeviceCorpusExplorer", Capped)
        mp.setattr(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
        mp.setattr(jax_corpus, "_effective_cpus", lambda: 1)
        for name, rows in runs.items():
            t0 = time.perf_counter()
            results = jax_corpus.analyze_corpus(rows, store_dir=store_dir, use_device=True,
                                                processes=1, router=False,
                                                **chip_smoke.STORE_KW)
            doc["runs"][name] = chip_smoke.store_summary(results)
            print(name, f"{time.perf_counter() - t0:.1f} s",
                  [row[:5] for row in doc["runs"][name]])
    for variant in (0, 1):
        with tempfile.TemporaryDirectory() as tmp:
            for code, _creation, name in proxy_pair(seed=5, variant=variant):
                Path(tmp, name.replace("#", "_") + ".hex").write_text(code)
            out = subprocess.run([sys.executable, str(ROOT / "myth"), "graph", tmp, "--json"],
                                 capture_output=True, text=True, check=True, cwd=ROOT)
        doc["graph"][f"proxy_pair_5_{variant}"] = chip_smoke.graph_payload(
            json.loads(out.stdout))
    PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}")


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).parent), str(ROOT)]
    if sys.argv[1:] == ["--pin-store"]:
        pin_store()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_store.py --pin-store")
