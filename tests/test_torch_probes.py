"""The port's concrete probes against the JAX package's.

`mythril_tpu_torch.analysis.dispatcher_probe` and `.hybrid_fuzz` run here
on the CPU (`device="cpu"`) and are held to the JAX package's functions,
pinned in tests/test_torch_probes_pinned.json (the JAX side re-runs take
~11 s a case on the CPU, so the tier-1 tests read the pin and a slow test
re-derives it from the JAX package):

- `probe_dispatcher`: every row (function, status, gas bounds, storage
  writes, coverage) on tests/analysis/test_dispatcher_probe.py's
  hand-built contract and on each of the 13 vendored contracts
  (chip_smoke.py holds the card to the same rows);
- `HybridFuzzer`: tests/analysis/test_hybrid_fuzz.py's three fast cases
  and metacoin.sol.o at tools/fuzz.py's defaults: generation 0's
  per-lane records (status, the journaled JUMPI decisions in order, the
  storage journal) exactly, and the run's covered branches, storage
  writes and triggers at the end; every flip witness, replayed on
  `run`, must take its flipped branch after the journaled prefix;
- the fuzzer's command line (`python -m
  mythril_tpu_torch.analysis.hybrid_fuzz`) against `run()`.

The pin also holds the full-width generation chip_smoke.py runs on the
card (4096 lanes of exceptions.sol.o: the covered set, storage writes,
trigger kinds and a digest of every lane's record). Regenerate it with

    PYTHONPATH=. python tests/test_torch_probes.py --pin-probes

(the JAX package on the CPU, a few minutes).
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu_torch.analysis import dispatcher_probe as port_probe
from mythril_tpu_torch.analysis import hybrid_fuzz as port_fuzz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PINNED = Path(__file__).with_name("test_torch_probes_pinned.json")
VENDORED = ROOT / "tests" / "testdata" / "vendored" / "inputs"
VENDORED_NAMES = sorted(f.name for f in VENDORED.glob("*.sol.o"))


def simple_probe_contract() -> str:
    """tests/analysis/test_dispatcher_probe.py's dispatcher: selector
    0xaa000000 writes storage, anything else reverts."""
    shift = bytes.fromhex("600035") + bytes([0x60, 224]) + bytes.fromhex("1c")
    check = bytes.fromhex("63aa000000") + bytes.fromhex("14")
    revert_arm = bytes.fromhex("60006000fd")
    dest = len(shift) + len(check) + 3 + len(revert_arm)
    prefix = shift + check + bytes([0x60, dest, 0x57]) + revert_arm
    return (prefix + bytes.fromhex("5b600160005500")).hex()


def two_gate_contract() -> str:
    """tests/analysis/test_hybrid_fuzz.py's: word0 == 0x42 guards gate 1,
    word1 == 0x1337 gate 2, both reach SSTORE(0, 0xbeef)."""
    code = bytearray(bytes.fromhex("600035" "6042" "14"))
    code += bytes([0x60, len(code) + 4, 0x57, 0x00, 0x5B])
    code += bytes.fromhex("602035" "611337" "14")
    code += bytes([0x60, len(code) + 4, 0x57, 0x00, 0x5B])
    code += bytes.fromhex("61beef60005500")
    return code.hex()


def assert_gate_contract() -> str:
    """tests/analysis/test_hybrid_fuzz.py's INVALID behind a 256-bit
    magic word (calldata word 0 == 0xa7)."""
    code = bytearray(bytes.fromhex("600035" "60a7" "14"))
    code += bytes([0x60, len(code) + 4, 0x57, 0x00, 0x5B, 0xFE])
    return code.hex()


def metacoin() -> str:
    return (VENDORED / "metacoin.sol.o").read_text().strip()


#: the probes: label -> (code, probe_dispatcher keyword arguments)
PROBES = {"simple": (simple_probe_contract, {"fuzz_lanes": 1})}
PROBES.update({name: (lambda name=name: (VENDORED / name).read_text().strip(), {})
               for name in VENDORED_NAMES})

#: the fuzz cases: label -> (code, HybridFuzzer keyword arguments); the
#: first three are the JAX tests' fast cases at their settings, the last
#: tools/fuzz.py's defaults
FUZZ = {
    "two_gate": (two_gate_contract, dict(calldata_len=64, lanes_per_generation=16,
                                         max_generations=6, seed=3)),
    "straight_line": (lambda: "6001600055600060015500",
                      dict(calldata_len=8, lanes_per_generation=4, max_generations=4,
                           seed=1)),
    "assert_gate": (assert_gate_contract, dict(calldata_len=32, lanes_per_generation=8,
                                               max_generations=4, seed=11)),
    "metacoin": (metacoin, dict(calldata_len=68, lanes_per_generation=32,
                                max_generations=6, flips_per_generation=8, seed=1)),
}

#: chip_smoke.py's full-width generation
FULL_WIDTH = dict(contract="exceptions.sol.o", calldata_len=36,
                  lanes_per_generation=4096, seed=5)


def jsonable(x):
    return json.loads(json.dumps(x))


def lane_records(out, n) -> list:
    """Each lane's (status, journaled JUMPI decisions in order, storage
    journal in order) from a finished batch (JAX arrays or port tensors)."""
    import numpy as np

    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    status, br_pc, br_taken, br_cnt, keys, vals, cnt = (
        host(t) for t in (out.status, out.br_pc, out.br_taken, out.br_cnt,
                          out.storage_keys, out.storage_vals, out.storage_cnt))

    def word(row):
        return hex(sum(int(row[i]) << (16 * i) for i in range(row.shape[-1])))

    records = []
    for i in range(n):
        k = min(int(br_cnt[i]), br_pc.shape[1])
        records.append([
            int(status[i]),
            [[int(br_pc[i, j]), bool(br_taken[i, j])] for j in range(k)],
            [[word(keys[i, j]), word(vals[i, j])] for j in range(int(cnt[i]))],
        ])
    return records


def records_digest(records) -> str:
    return hashlib.sha256(json.dumps(records).encode()).hexdigest()


def fuzz_run(module, code, kw, **extra):
    """(run() result, generation 0's lane records, flips) of `module`'s
    HybridFuzzer. Flips are [[pc, taken], journal prefix, calldata hex]."""
    records = []
    real = module.batch_run

    def recording(batch, table, **run_kw):
        out, steps = real(batch, table, **run_kw)
        if not records:
            records.extend(lane_records(out, batch.status.shape[0]))
        return out, steps

    flips = []
    replay = module._symbolic_replay

    def recording_replay(disassembly, calldata_len, script, **replay_kw):
        data = replay(disassembly, calldata_len, script, **replay_kw)
        if data is not None:
            pc, taken = script[-1]
            flips.append([[pc, not taken], [list(e) for e in script], bytes(data).hex()])
        return data

    module.batch_run, module._symbolic_replay = recording, recording_replay
    try:
        fuzzer = module.HybridFuzzer(code, **kw, **extra)
        result = fuzzer.run()
    finally:
        module.batch_run, module._symbolic_replay = real, replay
    return jsonable(result), records, flips


def witness_replays(code_hex, calldata_hex, target, prefix, device="cpu") -> bool:
    """The flip witness run on the port's `run` as the fuzzer runs a
    lane: its journal must follow `prefix` and take `target` there."""
    from mythril_tpu_torch.laser.batch.explore import DEFAULT_ADDRESS, DEFAULT_CALLER
    from mythril_tpu_torch.laser.batch.run import run
    from mythril_tpu_torch.laser.batch.state import make_batch, make_code_table

    table = make_code_table([bytes.fromhex(code_hex)], device=device)
    batch = make_batch(1, calldata=[bytes.fromhex(calldata_hex)], caller=DEFAULT_CALLER,
                       address=DEFAULT_ADDRESS, device=device)
    out, _ = run(batch, table, max_steps=4096)
    (record,) = lane_records(out, 1)
    want = [list(e) for e in prefix[:-1]] + [list(target)]
    return record[1][:len(want)] == want


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_rows_equal_the_jax_package(name, pinned):
    code, kw = PROBES[name]
    assert jsonable(port_probe.probe_dispatcher(code(), device="cpu", **kw)) == \
        pinned["probe"][name]


def test_probe_reads_the_jax_tests_behaviour(pinned):
    """The JAX suite's claims hold on the pinned rows the port equals:
    the selector lane stops after writing slot 0; empty calldata
    reverts; metacoin's two selector lanes return and cover more."""
    rows = {r["function"]: r for r in pinned["probe"]["simple"]}
    assert rows["0xaa000000"]["status"] == "stopped"
    assert rows["0xaa000000"]["storage_writes"] == {"0x0": "0x1"}
    assert rows["<empty calldata>"]["status"] == "reverted"
    meta = pinned["probe"]["metacoin.sol.o"]
    lanes = [r for r in meta if r["function"].startswith("0x")]
    empty = next(r for r in meta if r["function"] == "<empty calldata>")
    assert len(lanes) == 2 and all(r["status"] == "returned" for r in lanes)
    assert all(r["coverage_percent"] > empty["coverage_percent"] for r in lanes)


@pytest.fixture(scope="module")
def port_fuzz_runs():
    return {name: fuzz_run(port_fuzz, code(), kw, device="cpu")
            for name, (code, kw) in FUZZ.items()}


@pytest.mark.parametrize("name", list(FUZZ))
def test_fuzz_generation_zero_equals_the_jax_package(name, port_fuzz_runs, pinned):
    _, records, _ = port_fuzz_runs[name]
    assert records == pinned["fuzz"][name]["gen0"]


@pytest.mark.parametrize("name", list(FUZZ))
def test_fuzz_run_equals_the_jax_package(name, port_fuzz_runs, pinned):
    result, _, flips = port_fuzz_runs[name]
    want = pinned["fuzz"][name]["result"]
    for key in ("covered_branches", "storage_writes", "triggers", "generations",
                "corpus_size"):
        assert result[key] == want[key], key
    assert flips == pinned["fuzz"][name]["flips"]


@pytest.mark.parametrize("name", list(FUZZ))
def test_every_flip_witness_takes_its_branch(name, port_fuzz_runs):
    code, _ = FUZZ[name]
    _, _, flips = port_fuzz_runs[name]
    assert all(witness_replays(code(), data, target, prefix)
               for target, prefix, data in flips), flips
    if name in ("two_gate", "assert_gate", "metacoin"):
        assert flips


def test_fuzz_cracks_the_jax_tests_gates(port_fuzz_runs):
    """The JAX suite's assertions, on the port: both gates open in both
    directions and 0xbeef is written; the straight line stops after one
    generation; the assert witness carries 0xa7 in word 0."""
    gates, _, _ = port_fuzz_runs["two_gate"]
    assert {tuple(b) for b in gates["covered_branches"]} == {
        (pc, flag) for pc, _ in gates["covered_branches"] for flag in (True, False)}
    assert len({pc for pc, _ in gates["covered_branches"]}) == 2
    assert gates["storage_writes"]["0x0"] == ["0xbeef"]
    straight, _, _ = port_fuzz_runs["straight_line"]
    assert straight["generations"] == 1 and straight["covered_branches"] == []
    assert straight["storage_writes"]["0x0"] == ["0x1"]
    asserts, _, _ = port_fuzz_runs["assert_gate"]
    assert int(asserts["triggers"]["assert-violation"][0], 16) == 0xA7


def test_fuzz_command_line_prints_the_run(port_fuzz_runs, capsys):
    code, kw = FUZZ["two_gate"]
    assert port_fuzz.main(["-c", code(), "--calldata-len", "64", "--lanes", "16",
                           "--generations", "6", "--seed", "3", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == port_fuzz_runs["two_gate"][0]
    with pytest.raises(SystemExit):
        port_fuzz.main(["--device", "cpu"])  # no code given


def test_inputs_are_the_jax_suites_contracts():
    path = ROOT / "tests" / "analysis" / "test_hybrid_fuzz.py"
    spec = importlib.util.spec_from_file_location("jax_hybrid_fuzz_tests", path)
    jax_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tests)
    assert two_gate_contract() == jax_tests.two_gate_contract()
    source = path.read_text()
    assert '"6001600055600060015500"' in source and "60a7" in source


def test_probe_and_fuzz_default_to_the_card():
    """None means the card: without one the entry points raise rather
    than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_probe.probe_dispatcher("33ff")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fuzz.HybridFuzzer("33ff")


def jax_pin() -> dict:
    """The pin, from the JAX package on the CPU."""
    from mythril_tpu.analysis import dispatcher_probe as jax_probe
    from mythril_tpu.analysis import hybrid_fuzz as jax_fuzz

    doc = {"probe": {}, "fuzz": {}}
    for name, (code, kw) in PROBES.items():
        doc["probe"][name] = jsonable(jax_probe.probe_dispatcher(code(), **kw))
        print("probe", name, flush=True)
    for name, (code, kw) in FUZZ.items():
        result, records, flips = fuzz_run(jax_fuzz, code(), kw)
        doc["fuzz"][name] = {"code": code(), "settings": kw, "gen0": records,
                             "result": result, "flips": flips}
        print("fuzz", name, result["generations"], len(flips), flush=True)
    settings = dict(FULL_WIDTH)
    code = (VENDORED / settings.pop("contract")).read_text().strip()
    fuzzer = jax_fuzz.HybridFuzzer(code, **settings)
    real, records = jax_fuzz.batch_run, []

    def recording(batch, table, **run_kw):
        out, steps = real(batch, table, **run_kw)
        records.extend(lane_records(out, batch.status.shape[0]))
        return out, steps

    jax_fuzz.batch_run = recording
    try:
        fuzzer._run_generation(fuzzer._seed_inputs())
    finally:
        jax_fuzz.batch_run = real
    doc["full_width"] = dict(
        FULL_WIDTH, code=code,
        covered_branches=jsonable(sorted(fuzzer.covered)),
        storage_writes={hex(k): sorted(hex(v) for v in vs)
                        for k, vs in sorted(fuzzer.storage_writes.items())},
        trigger_kinds=sorted(fuzzer.triggers),
        digest=records_digest(records))
    print("full width", len(records), doc["full_width"]["trigger_kinds"], flush=True)
    return doc


@pytest.mark.slow
def test_pin_is_what_the_jax_package_gives(pinned):
    assert jax_pin() == pinned


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin-probes"]:
        sys.path.insert(0, str(ROOT))
        import conftest  # noqa: F401  (the suite's JAX settings)

        with contextlib.redirect_stderr(io.StringIO()):
            doc = jax_pin()
        PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        print("pinned", PINNED)
    else:
        raise SystemExit("usage: test_torch_probes.py --pin-probes")
