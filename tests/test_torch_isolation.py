"""The port stands alone: no jax, nothing of the JAX package.

A subprocess imports `mythril_tpu_torch`, runs a 4-lane CPU `run`, a
4-lane symbolic wave (`sym_run`, `ArenaView`, `reseed_wave`), the
wave's flip frontier (`flip_frontier`: harvest, candidates, the term
decode, `lower`), a `device_solve_batch` of one query (the SMT term
layer, `compile_program`, enumeration through `portfolio_eval`) and a
two-contract `DeviceCorpusExplorer` run (laser/batch/explore.py, with
its resilience, checkpoint, span and capture modules, on its default
specialized kernel), a blockjit run of a lowered block (specialize.py,
blockjit.py and the substep wrapper's plain version), a one-contract
`analyze_corpus` with its issue synthesis, replay and report in every
form (analysis/), the analyzer facade
(mythril/: `MythrilDisassembler`, `MythrilAnalyzer.fire_lasers` over a
two-contract corpus with its overlapped prepass, `dump_statespace`, and
the `disassemble` and `function-to-hash` commands), a query
through the host solver stack (`get_model`: the bit-blaster and the
CDCL of the port's own g++ library), the host walk of a contract under
`--device-ownership never` (the LASER engine, its plugins and the
detection modules), the static pass (`summary_for`) and the `lint`
command, a hybrid VMTests case (the host takeover), a job through the
analysis service (service/: its HTTP server, engine and client, the
metrics registry's exposition) and the `serve` command's parsing, and an
import of every module of the package (crypto/ and the precompiles
among them), and checks that `jax` never
entered `sys.modules`, that no module of the JAX package did either,
and that no shared object under `mythril_tpu/` is mapped into the
process (/proc/self/maps). A source scan finds no import of either in the
port's files or in chip_smoke.py. Without a CUDA device, an entry point
called with no device raises instead of carrying on on the CPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import sys
from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
from mythril_tpu_torch.laser.batch.state import storage_dict
from mythril_tpu_torch.laser import conformance  # noqa: F401
from mythril_tpu_torch import interop  # noqa: F401
from mythril_tpu_torch.support import accel
code = bytes([0x60, 0x05, 0x60, 0x03, 0x02, 0x60, 0x00, 0x55, 0x00])
out, steps = run(make_batch(4, device="cpu"), make_code_table([code], device="cpu"))
assert [storage_dict(out, i) for i in range(4)] == [{0: 15}] * 4, out
accel.probe()
from mythril_tpu_torch.laser import symbolic_wave
from mythril_tpu_torch.laser.batch.arena import ArenaView
from mythril_tpu_torch.laser.batch.symbolic import reseed_wave, sym_run
symb, table = symbolic_wave.make_wave(2, 2, device="cpu")
out, steps, active = sym_run(symb, table, max_steps=64)
view = ArenaView(out)
assert steps > 0 and view.count > 0, (steps, view.count)
reseed_wave(out, *(t.numpy() for t in (symb.base.code_id, symb.base.calldata,
    symb.base.calldatasize, symb.base.callvalue, symb.base.balance,
    symb.base.storage_keys, symb.base.storage_vals, symb.base.storage_cnt)),
    symb.base.storage_cnt.numpy() > 0)
from mythril_tpu_torch.laser import flip_frontier as ff
from mythril_tpu_torch.laser.smt import terms as T
from mythril_tpu_torch.laser.smt.solver import portfolio
by = ff.lanes_by_contract(symb.base.code_id.numpy())
tracks = {}
ff.harvest(view, tracks, by)
cands, tried, opaque = ff.collect_candidates(view, tracks, by)
lowered, kept = ff.lower_flips([c for _, _, c, _ in cands])
assert len(kept) == len(cands) and tried >= len(cands), (tried, len(cands))
x = T.bv_var("iso_x", 4)
(v,) = portfolio.device_solve_batch([[T.eq(T.add(x, T.bv_const(3, 4)), T.bv_const(1, 4))]],
                                    device="cpu")
assert (v.status, v.via, v.assignment) == ("sat", "enum", {"iso_x": 14}), v
from mythril_tpu_torch.laser.batch import explore
res = explore.DeviceCorpusExplorer(["60003560f81c604214600d57005b600160005500", "33ff"],
                                   lanes_per_contract=4, waves=2, steps_per_wave=64,
                                   device="cpu").run()
assert res["stats"]["waves"] >= 2, res["stats"]
assert "selfdestruct" in res["contracts"][1]["triggers"], res["contracts"][1]
assert res["stats"]["specialized"] == 1, res["stats"]
import torch
from mythril_tpu_torch.laser.batch import blockjit, specialize
from mythril_tpu_torch.ops import substep
alu = bytes.fromhex("6001600302600701605519168015145000")
alu_table = make_code_table([alu], device="cpu")
phases = specialize.phases_for(specialize.signature_for(alu), fuse=False,
                               block_depth=blockjit.block_depth_for(alu))
blk = torch.from_numpy(blockjit.build_block_table([alu], alu_table.ops.shape[1] - 33))
out, steps, subs, blocks = specialize.SpecializedKernel(phases).run(
    make_batch(2, device="cpu"), alu_table, blk, max_steps=32)
assert int(subs) > 0 and int(blocks) > 0 and substep.LAUNCHES == 0, (int(subs), int(blocks))
from mythril_tpu_torch.analysis import corpus, evidence, prepass, replay  # noqa: F401
from mythril_tpu_torch.analysis.report import Report
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.interfaces import cli
from mythril_tpu_torch.support.signatures import SignatureDB
(owned,) = corpus.analyze_corpus([("604260003560f81c14600d57005b33ff", "", "g")],
                                 waves=8, device="cpu")
assert owned["owned"] and owned["issues"][0]["swc-id"] == "106", owned
assert replay.replays_to(owned["issues"][0], device="cpu")
contract = EVMContract(code="604260003560f81c14600d57005b33ff", name="g")
report = Report(contracts=[contract])
for issue in owned["issue_objects"]:
    issue.add_code_info(contract)
    report.append_issue(issue)
assert all(f() for f in (report.as_text, report.as_markdown, report.as_json,
                         report.as_swc_standard_format))
assert SignatureDB().get("0xa9059cbb") == ["transfer(address,uint256)"]
import contextlib, io, json
from mythril_tpu_torch.analysis.static import summary_for
summary = summary_for("604260003560f81c14600d57005b33ff")
assert "AccidentallyKillable" in summary.applicable_modules()[0], summary.stats()
lint_out = io.StringIO()
with contextlib.redirect_stdout(lint_out):
    assert cli.main(["lint", "--bin-runtime", "-c", "604260003560f81c14600d57005b33ff",
                     "-o", "json"]) == 0
assert json.loads(lint_out.getvalue())[0]["code_hash"] == summary.code_hash
from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
dis = MythrilDisassembler()
for code in ("604260003560f81c14600d57005b33ff", "600035600757005bfe"):
    dis.load_from_bytecode(code, bin_runtime=True)
facade = MythrilAnalyzer(dis, strategy="bfs", use_onchain_data=False, execution_timeout=30,
                         address="0x" + "11" * 20,
                         max_depth=64, loop_bound=3, deterministic_solving=True,
                         specialize=False, blockjit=False, device="cpu")
facade_report = json.loads(facade.fire_lasers(transaction_count=1).as_json())
assert sorted(i["swc-id"] for i in facade_report["issues"]) == ["106", "110"], facade_report
assert len(facade.dump_statespace(dis.contracts[1])["nodes"]) > 0
cmd_out = io.StringIO()
with contextlib.redirect_stdout(cmd_out):
    assert cli.main(["disassemble", "--bin-runtime", "-c", "33ff"]) == 0
    assert cli.main(["function-to-hash", "transfer(address,uint256)"]) == 0
assert cmd_out.getvalue() == "Runtime Disassembly: \n0 CALLER\n1 SUICIDE\n\n0xa9059cbb\n", cmd_out
import os
from mythril_tpu_torch.laser.smt import ULT, symbol_factory
from mythril_tpu_torch.support.model import get_model
q = symbol_factory.BitVecSym("iso_q", 256)
m = get_model((q * 3 == 9, ULT(q, 10)), enforce_execution_time=False)
assert m.eval_int(q) == 3, m.assignment
from mythril_tpu_torch.support.support_args import args
args.device_ownership, args.deterministic_solving = "never", True
(walked,) = corpus.analyze_corpus([("604260003560f81c14600d57005b33ff", "", "g")],
                                  waves=2, device="cpu")
assert not walked["owned"] and walked["complete"] and walked["states"] > 0, walked
assert [i["swc-id"] for i in walked["issues"]] == ["106"], walked["issues"]
from mythril_tpu_torch.laser import conformance
(case,) = [c for c in conformance.load_vmtests()[0] if c.name == "vmSha3Test/sha3_bigOffset2"]
assert conformance.run_cases([case], device="cpu") == {case.name: "pass"}
from mythril_tpu_torch.observe.registry import registry
from mythril_tpu_torch.service.client import ServiceClient
from mythril_tpu_torch.service.engine import ServiceConfig
from mythril_tpu_torch.service.server import AnalysisServer
srv = AnalysisServer(ServiceConfig(stripes=1, lanes_per_stripe=4, steps_per_wave=32,
                                   host_walk=False, device="cpu")).start()
client = ServiceClient(srv.url)
job = client.report(client.submit("33ff"), wait_s=120)
srv.close()
assert job["report"]["device"]["triggers"] == {"selfdestruct": 1}, job
assert "# TYPE mtpu_service_waves_total counter" in registry().prometheus_text()
serve_args = cli.build_parser().parse_args(["serve", "--device", "cpu", "--port", "0"])
assert cli.serve_refusals(serve_args) == []
import importlib, pkgutil
import mythril_tpu_torch
for mod in pkgutil.walk_packages(mythril_tpu_torch.__path__, "mythril_tpu_torch."):
    if not mod.name.endswith("__main__"):
        importlib.import_module(mod.name)
from mythril_tpu_torch.laser.ethereum import natives
assert natives.sha256(list(b"abc"))[:2] == [0xBA, 0x78], natives.sha256(list(b"abc"))[:2]
assert natives.ec_add([0] * 128) == [0] * 64
paths = {line.split()[-1] for line in open("/proc/self/maps") if line.count("/")}
jax_dir = os.path.realpath("mythril_tpu") + os.sep
port_lib = os.path.realpath("mythril_tpu_torch/_build/libmythril_torch_host.so")
assert port_lib in paths, sorted(p for p in paths if p.endswith(".so"))
print("MAPPED", sorted(p for p in paths if p.startswith(jax_dir)))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "mythril_tpu" or m.startswith("mythril_tpu."))
print("BAD", bad)
"""

# an import statement (or importlib call) naming jax, or the JAX package
# (mythril_tpu not followed by _torch)
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|mythril_tpu\b(?!_torch))"
    r"|import_module\(\s*['\"](?:jax|mythril_tpu(?!_torch))",
    re.MULTILINE,
)


def test_port_runs_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    assert "MAPPED []" in proc.stdout, proc.stdout


def _sources():
    return sorted((ROOT / "mythril_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, hits


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "from jax import lax", "import jax.numpy as jnp",
                 "from mythril_tpu.ops import u256", "import mythril_tpu",
                 "importlib.import_module('mythril_tpu.ops')"):
        assert FORBIDDEN.search(line), line
    for line in ("from mythril_tpu_torch.ops import u256", "import torch",
                 "# the JAX package's mythril_tpu/ops/u256.py"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_without_device_raise_where_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mythril_tpu_torch import interop
    from mythril_tpu_torch.laser import symbolic_wave
    from mythril_tpu_torch.laser.batch import make_batch, make_code_table
    from mythril_tpu_torch.laser.conformance import run_cases
    from mythril_tpu_torch.laser import flip_frontier
    from mythril_tpu_torch.laser.batch import explore
    from mythril_tpu_torch.analysis import corpus, replay
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.laser.smt import terms as T
    from mythril_tpu_torch.laser.smt.solver import device_race, portfolio
    from mythril_tpu_torch.ops.keccak import keccak256
    from mythril_tpu_torch.service.engine import AnalysisEngine

    wave_np = interop.symbatch_to_numpy(symbolic_wave.make_wave(1, 2, device="cpu")[0])
    x = T.bv_var("iso_nodev_x", 8)
    query = [T.ult(x, T.bv_const(9, 8))]
    prog = portfolio.compile_program(query)
    for call in (lambda: make_batch(2), lambda: make_code_table([b"\x00"]),
                 lambda: run_cases([]), lambda: keccak256(b""),
                 lambda: symbolic_wave.make_wave(1, 2),
                 lambda: interop.symbatch_from_numpy(wave_np),
                 lambda: portfolio.device_solve_batch([query]),
                 lambda: portfolio.device_enumerate(prog),
                 lambda: portfolio.device_check(query),
                 lambda: device_race.DeviceRace(query),
                 lambda: portfolio.debug_eval(prog, {}),
                 lambda: portfolio.rank_impact_vars(prog),
                 lambda: flip_frontier.run_generations(1, 2, 1),
                 lambda: explore.DeviceCorpusExplorer(["33ff"]),
                 lambda: explore.DeviceSymbolicExplorer("33ff"),
                 lambda: corpus.analyze_corpus([("33ff33ff", "", "k")]),
                 lambda: replay.replay_sequence({"steps": []}, 0),
                 lambda: cli.main(["analyze", "--bin-runtime", "-c", "33ff33ff"]),
                 lambda: MythrilAnalyzer(MythrilDisassembler()),
                 lambda: AnalysisEngine(),
                 lambda: cli.main(["serve", "--port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_probe_reports_without_choosing():
    from mythril_tpu_torch.support import accel

    info = accel.probe()
    assert info["cuda"] == torch.cuda.is_available()
    assert set(info) >= {"cuda", "capability", "sm90a", "kernels_built"}
