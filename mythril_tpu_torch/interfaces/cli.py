"""`python -m mythril_tpu_torch analyze`: runtime bytecode in, the JAX
package's `Report` out, through the analyzer facade, as the JAX `myth
analyze` runs it; `lint`, `serve`, `submit`, `disassemble`,
`list-detectors`, `function-to-hash` and `version`.

`analyze` loads the bytecode (`-c`, or `-f` once per contract of a
corpus) through `MythrilDisassembler` and runs `MythrilAnalyzer`
(mythril/mythril_analyzer.py) with the JAX command's flags: one
contract gets SymExecWrapper's own device prepass, then the host walk;
two or more get the overlapped corpus prepass (analysis/corpus.py
`OverlappedPrepass`) on a thread beside the walk of every contract, then
the witness merge; `-j` writes the first contract's statespace and `-g`
its call graph instead. The report prints as text, markdown, json or
jsonv2. A library caller of the corpus path calls
analysis/corpus.py:analyze_corpus.

Creation bytecode is refused: the port analyzes runtime code, so pass it
with `--bin-runtime`. A contract whose walk raised is not analyzed: the
report says so (json and jsonv2 carry `partial` and the per-contract
status; text and markdown end with the contracts not analyzed, in place
of the templates' "completed successfully"; every form prints the
reasons on stderr) and the command exits with 1. `--deadline` makes the
contracts it leaves unstarted `skipped` in a partial report (exit 0), or
with `--on-timeout fail` exits 1 with "Analysis deadline expired".

`--device cuda` (the default) runs on the card and raises where there is
none; `--device cpu` runs the plain PyTorch versions of the kernels and
keeps every solver race on the CPU. `--device-prepass`,
`--device-prepass-budget` and `--device-solving` ("never" starts no race
of the card beside the CDCL) are the JAX switches; `--attacker-address`
and `--creator-address` set the actors. The static pass (analysis/static)
runs on every `analyze`, as in the JAX package; `--no-static-prune` turns
it off. The explorer's waves run the contract-specialized loop, as in the
JAX package: `--no-specialize` restores the generic kernel and
`--no-blockjit` the fuse-only one. The port has no chain client:
on-chain data (the default, as in the JAX package) makes storage concrete
and every chain read fails, `--no-onchain-data` keeps storage symbolic.

Refused, with the module each needs named (exit 2), never ignored:
Solidity input, `--truffle`, `--solv`, `--solc-json` (solc), `-a`,
`--rpc`, `--infura-id` (the chain RPC client), `-q` (the online signature
lookup), `--devices N` above 1 (the device mesh), `--store` or
MYTHRIL_STORE_DIR (the verdict store), `--host-first-funnel`,
`--sparse-pruning` and `--unconstrained-storage` (not in the port's
explorer and host walk), `--no-static-answer` (the static-answer tier,
which only analysis/corpus.py:analyze_corpus and `serve` have), and the
`hash-to-address`, `leveldb-search` and `read-storage` commands
(leveldb, the RPC client).

`lint` runs the static pass and nothing else (CFG and prune statistics,
the detector screen and the static findings, as text or json), and
never touches the card. `--fail-on CHECK` exits 1 when the check fires
on any contract, 2 when the check is unknown.

`serve` runs the persistent analysis service (service/server.py) until
a drain (SIGTERM, SIGINT or POST /v1/drain), with the JAX package's
`myth serve` flags and defaults for the single arena, on the card
unless `--device cpu`; `submit` sends bytecode to a running service and
prints the report as JSON. The flags of modules the port does not have
are refused with an error that names the module, rather than ignored:
`--devices N` above 1 (the device mesh), `--journal` and `--recover`
(service/journal.py), `--store` (the verdict store, store/store.py),
`--router` (routing/), `--kernel-pack` and `--kernel-cache` (the
compile plane), and their environment variables; so is `submit
--address` (the chain RPC client). `--no-store`, `--no-router` and
`--no-aot` ask for what the port always does, and are accepted.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Tuple

ANALYZE_LIST = ("analyze", "a")
#: `serve` settings whose modules the port lacks: (what asks for it,
#: the module it needs)
SERVE_REFUSED = (
    ("--devices N > 1", "the device mesh (parallel/mesh.py, topology.py)"),
    ("--journal", "the durable job journal (service/journal.py)"),
    ("--recover", "the durable job journal (service/journal.py)"),
    ("--store / MYTHRIL_STORE_DIR", "the verdict store (store/store.py)"),
    ("--router / MYTHRIL_ROUTER_DIR", "the learned router (routing/)"),
    ("--kernel-pack", "the compile plane (compileplane/)"),
    ("--kernel-cache / MYTHRIL_KERNEL_CACHE", "the compile plane (compileplane/)"),
)
#: what refused inputs and flags need: the chain RPC client, solc
NO_RPC = "the chain RPC client (ethereum/interface/rpc), which is not ported"
NO_SOLC = (
    "a solc binary and the Solidity front end (solidity/), which are not ported"
)
#: the JAX package's subcommands whose modules the port lacks
UNPORTED_COMMANDS = (
    ("hash-to-address", "converts the hashes in the blockchain to ethereum address"),
    ("read-storage", "Retrieves storage slots from a given address through rpc"),
    ("leveldb-search", "Searches the code fragment in local leveldb"),
)
UNPORTED_COMMAND_NEEDS = {
    "hash-to-address": "a chain's leveldb (mythril/mythril_leveldb.py), which is "
    "not ported",
    "leveldb-search": "a chain's leveldb (mythril/mythril_leveldb.py), which is "
    "not ported",
    "read-storage": NO_RPC,
}
OUTFORMS = ("text", "markdown", "json", "jsonv2")
LINT_OUTFORMS = ("text", "json", "jsonv2")


def _add_code_inputs(parser: argparse.ArgumentParser, purpose: str) -> None:
    parser.add_argument(
        "-c", "--code", metavar="BYTECODE",
        help='hex-encoded bytecode string ("6060604052...")',
    )
    parser.add_argument(
        "-f", "--codefile", metavar="BYTECODEFILE", action="append",
        type=argparse.FileType("r"),
        help="file containing hex-encoded bytecode; repeat for a corpus",
    )
    parser.add_argument(
        "--bin-runtime", action="store_true",
        help="consider the input bytecode as runtime code" + purpose,
    )


def _add_unported_inputs(parser: argparse.ArgumentParser) -> None:
    """The JAX command's other inputs, parsed so that they are refused
    with what they need named (`input_refusals`)."""
    parser.add_argument(
        "solidity_files", nargs="*",
        help="Solidity input files (refused: the port has no solc)",
    )
    parser.add_argument(
        "-a", "--address", metavar="CONTRACT_ADDRESS",
        help="pull contract from the blockchain (refused: the port has no "
        "chain client)",
    )
    parser.add_argument(
        "--rpc", metavar="HOST:PORT / ganache / infura-[network_name]",
        help="custom RPC settings (refused: the port has no chain client)",
    )
    parser.add_argument(
        "--solv", metavar="SOLV", help="solidity compiler version (refused)"
    )
    parser.add_argument(
        "--solc-json", help="solc standard-json settings (refused)"
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m mythril_tpu_torch",
        description="Security analysis of EVM runtime bytecode on the card",
    )
    commands = parser.add_subparsers(dest="command")
    analyze = commands.add_parser(
        "analyze", aliases=["a"], help="analyze runtime bytecode"
    )
    _add_code_inputs(
        analyze,
        " (required: the port analyzes runtime code)",
    )
    _add_unported_inputs(analyze)
    analyze.add_argument(
        "-o", "--outform", choices=OUTFORMS, default="text",
        metavar="<text/markdown/json/jsonv2>", help="report output format",
    )
    outputs = analyze.add_argument_group("commands")
    outputs.add_argument(
        "-g", "--graph", metavar="OUTPUT_FILE",
        help="generate a control flow graph (HTML) of the first contract",
    )
    outputs.add_argument(
        "-j", "--statespace-json", metavar="OUTPUT_FILE",
        help="dumps the statespace json of the first contract",
    )
    outputs.add_argument(
        "--truffle", action="store_true",
        help="analyze a truffle project (needs solc: refused)",
    )
    outputs.add_argument(
        "--infura-id", help="set infura id for onchain analysis (refused: "
        "the port has no chain client)",
    )
    options = analyze.add_argument_group("options")
    options.add_argument(
        "-m", "--modules", metavar="MODULES",
        help="Comma-separated list of security analysis modules",
    )
    options.add_argument(
        "--max-depth", type=int, default=128,
        help="Maximum recursion depth for symbolic execution",
    )
    options.add_argument(
        "--call-depth-limit", type=int, default=3,
        help="Maximum call depth limit for symbolic execution",
    )
    options.add_argument(
        "--strategy", choices=["dfs", "bfs", "naive-random", "weighted-random"],
        default="bfs", help="Symbolic execution strategy",
    )
    options.add_argument(
        "-b", "--loop-bound", type=int, default=3, metavar="N",
        help="Bound loops at n iterations",
    )
    options.add_argument(
        "-t", "--transaction-count", type=int, default=2,
        help="Maximum number of transactions issued by laser",
    )
    options.add_argument(
        "--execution-timeout", type=int, default=86400,
        help="The amount of seconds to spend on symbolic execution",
    )
    options.add_argument(
        "--solver-timeout", type=int, default=10000,
        help="The maximum amount of time(in milli seconds) the solver spends "
        "for queries from analysis modules",
    )
    options.add_argument(
        "--create-timeout", type=int, default=10,
        help="The amount of seconds to spend on the initial contract creation",
    )
    options.add_argument(
        "--parallel-solving", action="store_true",
        help="Enable solving solver queries in parallel (a query the CDCL "
        "leaves unknown gets one portfolio search where the analysis runs)",
    )
    options.add_argument(
        "--no-onchain-data", action="store_true",
        help="Don't attempt to retrieve contract code, variables and balances "
        "from the blockchain (the port has no chain client: with on-chain "
        "data on, storage is concrete and every chain read fails)",
    )
    options.add_argument(
        "--deterministic-solving", action="store_true",
        help="Conflict-budget solver marathons so reports are reproducible "
        "across machines and load (slightly less complete on hard queries "
        "than pure wall budgets)",
    )
    options.add_argument(
        "--deadline", type=float, default=None, metavar="SECONDS",
        help="Wall-clock budget for the WHOLE run: solver queries clamp to "
        "it, device waves stop at it, and on expiry the analysis degrades per "
        "--on-timeout instead of running past the budget",
    )
    options.add_argument(
        "--on-timeout", choices=["partial", "fail"], default="partial",
        help="What an expired --deadline produces: 'partial' emits the report "
        "built so far, marked partial with per-contract completion status and "
        "degradation-reason counts; 'fail' exits 1 with an error",
    )
    options.add_argument(
        "--corpus-shard", default=None, metavar="I/N",
        help="Analyze only this host's shard of the input contracts "
        "(deterministic content-hash partition; run one process per host "
        "with I=0..N-1 and merge the reports)",
    )
    options.add_argument(
        "--sparse-pruning", action="store_true",
        help="Checks for reachability after the end of tx (refused: its "
        "branch of the host walk is not in the port)",
    )
    options.add_argument(
        "--unconstrained-storage", action="store_true",
        help="Default storage value is symbolic (refused: its branch of the "
        "host walk is not in the port)",
    )
    options.add_argument(
        "--no-static-prune", action="store_true",
        help="Disable the static bytecode prepass (CFG recovery + constant "
        "dataflow): detection-module pre-screening, dispatcher-seed masking, "
        "and flip-frontier pruning all switch off (the differential baseline "
        "for a suspected wrong prune)",
    )
    options.add_argument(
        "--no-static-answer", action="store_true",
        help="the static-answer triage tier (refused: the analyzer facade "
        "walks every contract; only analysis/corpus.py:analyze_corpus has "
        "the tier)",
    )
    options.add_argument(
        "--store", default=None, metavar="DIR",
        help="cross-run verdict store (not ported: refused)",
    )
    options.add_argument(
        "--no-store", action="store_true",
        help="no verdict store tier (the port has none)",
    )
    options.add_argument(
        "--no-specialize", action="store_true",
        help="Disable per-contract specialized step kernels (opcode-set "
        "phase pruning + superblock fusion from the static summary): device "
        "waves run the generic opcode-switch interpreter — the differential "
        "baseline for a suspected specialization bug",
    )
    options.add_argument(
        "--no-blockjit", action="store_true",
        help="Disable the block-level JIT (whole CFG basic blocks advanced "
        "per kernel iteration): specialized kernels fall back to superblock "
        "fusion only — the differential baseline for a suspected "
        "block-lowering bug (env: MYTHRIL_NO_BLOCKJIT=1)",
    )
    options.add_argument(
        "--host-first-funnel", action="store_true",
        help="the legacy host-first solver funnel (not in the port's "
        "explorer: refused)",
    )
    options.add_argument(
        "--sprint-cap-s", type=float, default=None, metavar="SECONDS",
        help="Wall cap for the escalation ladder's host-CDCL pass over one "
        "wave's flip survivors (default 5.0; 0 defers every survivor); "
        "capped queries are recorded SPRINT_PREEMPTED and retried next wave",
    )
    options.add_argument(
        "--capture-queries", default=None, metavar="DIR",
        help="Solver query flight recorder: serialize every solved SMT query "
        "into DIR as a content-addressed, replayable artifact",
    )
    options.add_argument(
        "--device-prepass", choices=["auto", "always", "never"], default="auto",
        help="Run the device symbolic exploration before the host walk (auto "
        "and always: on the --device)",
    )
    options.add_argument(
        "--device-solving", choices=["auto", "always", "never"], default="auto",
        help="Let the card's portfolio race the CDCL on solver queries the "
        "sprint cannot decide (auto and always: on; never starts no race)",
    )
    options.add_argument(
        "--device-prepass-budget", type=float, default=12.0,
        help="Wall-clock seconds the device prepass may spend per contract",
    )
    options.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="device groups (the port runs one card: N > 1 is refused)",
    )
    options.add_argument(
        "--device-ownership", choices=["auto", "never"], default="auto",
        help="Let the device OWN contracts its exploration covered end to "
        "end (auto); never walks every contract on the host",
    )
    options.add_argument("--phrack", action="store_true", help="Phrack-style call graph")
    options.add_argument(
        "--enable-physics", action="store_true", help="enable graph physics simulation"
    )
    options.add_argument(
        "-q", "--query-signature", action="store_true",
        help="Lookup function signatures through www.4byte.directory "
        "(refused: it needs the network)",
    )
    options.add_argument(
        "--enable-iprof", action="store_true",
        help="enable the instruction profiler",
    )
    options.add_argument(
        "--disable-dependency-pruning", action="store_true",
        help="Deactivate dependency-based pruning",
    )
    options.add_argument(
        "--enable-coverage-strategy", action="store_true",
        help="enable coverage based search strategy (parsed and ignored, "
        "as in the JAX package)",
    )
    options.add_argument(
        "--custom-modules-directory", metavar="CUSTOM_MODULES_DIRECTORY",
        help="designates a separate directory to search for custom analysis "
        "modules (passed on and read nowhere, as in the JAX package)",
    )
    options.add_argument(
        "--attacker-address", metavar="ATTACKER_ADDRESS",
        help="Designates a specific attacker address to use during analysis",
    )
    options.add_argument(
        "--creator-address", metavar="CREATOR_ADDRESS",
        help="Designates a specific creator address to use during analysis",
    )
    options.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="run on the card (cuda, the default) or the plain PyTorch "
        "versions on the CPU",
    )
    disassemble = commands.add_parser(
        "disassemble", aliases=["d"], help="Disassembles the contract"
    )
    _add_code_inputs(disassemble, " (default: creation bytecode)")
    _add_unported_inputs(disassemble)
    detectors = commands.add_parser(
        "list-detectors", help="Lists available detection modules"
    )
    detectors.add_argument(
        "-o", "--outform", choices=OUTFORMS, default="text",
        metavar="<text/markdown/json/jsonv2>", help="output format",
    )
    to_hash = commands.add_parser(
        "function-to-hash", help="Returns the hash signature of the function"
    )
    to_hash.add_argument(
        "func_name", help="calculate function signature hash", metavar="SIGNATURE"
    )
    version = commands.add_parser("version", help="Outputs the version")
    version.add_argument(
        "-o", "--outform", choices=OUTFORMS, default="text",
        metavar="<text/markdown/json/jsonv2>", help="output format",
    )
    for name, what in UNPORTED_COMMANDS:
        refused = commands.add_parser(name, help=f"{what} (not ported: refused)")
        refused.add_argument("rest", nargs=argparse.REMAINDER)
    lint = commands.add_parser(
        "lint",
        help="Static bytecode analysis only: CFG recovery, constant "
        "dataflow, dead-code/dead-branch findings, and the detector "
        "pre-screen (host work, no card)",
    )
    _add_code_inputs(lint, " (without it, the bytecode is creation code)")
    lint.add_argument(
        "-o", "--outform", choices=LINT_OUTFORMS, default="text",
        metavar="<text/json/jsonv2>", help="lint output format",
    )
    lint.add_argument(
        "--fail-on", action="append", metavar="CHECK", default=None,
        help="exit nonzero when the named lint check fires on any contract "
        "(repeatable), a CI gate. Checks: unreachable-code, "
        "invalid-jump-target, stack-underflow, dead-branch, inert-function, "
        "tainted-jump-target, tainted-delegatecall-target, "
        "tx-origin-as-auth, unprotected-selfdestruct, "
        "delegatecall-to-upgradeable-target, proxy-storage-collision, "
        "tainted-cross-contract-call-arg, untrusted-return-data-in-guard",
    )
    _add_serve(commands)
    _add_submit(commands)
    return parser


def _add_serve(commands) -> None:
    """`serve`: the JAX package's `myth serve` flags and defaults."""
    serve = commands.add_parser(
        "serve",
        help="Run the persistent analysis service: a long-lived daemon that "
        "owns the card and serves analysis jobs over HTTP/JSON",
    )
    serve.add_argument("--host", default="127.0.0.1", help="bind address")
    serve.add_argument(
        "--port", type=int, default=7341, help="listen port (0 = ephemeral)"
    )
    serve.add_argument(
        "--stripes", type=int, default=4,
        help="arena stripes (max concurrently-resident contracts)",
    )
    serve.add_argument(
        "--lanes-per-stripe", type=int, default=8, help="device lanes per stripe"
    )
    serve.add_argument(
        "--steps-per-wave", type=int, default=256, help="EVM steps per wave"
    )
    serve.add_argument(
        "--max-waves", type=int, default=2,
        help="device waves per job before the host walk",
    )
    serve.add_argument(
        "--queue-capacity", type=int, default=64,
        help="admission queue bound (full queue answers 429)",
    )
    serve.add_argument(
        "--host-workers", type=int, default=1,
        help="host-analysis worker threads consuming finished stripes",
    )
    serve.add_argument(
        "--no-host-walk", action="store_true",
        help="device-only reports (skip the per-job host walk)",
    )
    serve.add_argument(
        "--execution-timeout", type=int, default=8,
        help="seconds of host walk per job",
    )
    serve.add_argument(
        "--transaction-count", type=int, default=2,
        help="attacker transactions the host walk models",
    )
    serve.add_argument(
        "--checkpoint-dir", default=None,
        help="where drain checkpoints land (default: a temp dir)",
    )
    serve.add_argument(
        "--no-pipeline", action="store_true",
        help="lock-step waves: the JAX package's flag, accepted as it is "
        "the port's only schedule for `serve` (pipelined waves served "
        "slower on the card; ServiceConfig(pipeline=True) keeps them for "
        "parity checks)",
    )
    serve.add_argument(
        "--no-specialize", action="store_true",
        help="disable contract-specialized loops (phase pruning + "
        "superblock fusion); every wave runs the generic interpreter",
    )
    serve.add_argument(
        "--no-blockjit", action="store_true",
        help="disable the block-level JIT; specialized loops keep "
        "superblock fusion only (env: MYTHRIL_NO_BLOCKJIT=1)",
    )
    serve.add_argument(
        "--no-static-prune", action="store_true",
        help="disable the static layer for the whole service (detector "
        "pre-screen, seed mask, static-answer triage)",
    )
    serve.add_argument(
        "--no-static-answer", action="store_true",
        help="keep the static prepass but disable ONLY the static-answer "
        "triage tier",
    )
    serve.add_argument(
        "--devices", type=int, default=1, metavar="N",
        help="device groups (the port serves one: N > 1 is refused)",
    )
    serve.add_argument(
        "--observe-out", default=None, metavar="DIR",
        help="telemetry output directory: degradation flight-recorder "
        "dumps land here and the drain's final flush prefers it over the "
        "checkpoint dir (live views: /metrics, /trace)",
    )
    serve.add_argument(
        "--no-observe", action="store_true",
        help="disable span/attribution/journey telemetry recording",
    )
    serve.add_argument(
        "--capture-queries", default=None, metavar="DIR",
        help="every SMT query the service's walks solve lands in DIR as a "
        "replayable artifact; live loss/capture counters at /stats solver.*",
    )
    serve.add_argument(
        "--store", default=None, metavar="DIR",
        help="cross-run verdict store (not ported: refused)",
    )
    serve.add_argument(
        "--no-store", action="store_true",
        help="no verdict store tier (the port has none)",
    )
    serve.add_argument(
        "--journal", default=None, metavar="DIR",
        help="durable job journal (not ported: refused)",
    )
    serve.add_argument(
        "--recover", action="store_true",
        help="replay the --journal DIR at startup (not ported: refused)",
    )
    serve.add_argument(
        "--no-breakers", action="store_true",
        help="disable the tier circuit breakers (device dispatch, "
        "device-first solving, the specialized-kernel tier)",
    )
    serve.add_argument(
        "--quarantine-strikes", type=int, default=2, metavar="N",
        help="wave-fault strikes before a codehash is quarantined; one "
        "strike short of N the job runs in a solo wave",
    )
    serve.add_argument(
        "--no-arena-warmup", action="store_true",
        help="skip the background arena warmup at startup (the build and "
        "load of the wave's kernels and one all-halt wave): the service "
        "reports ready at once and the FIRST request pays them",
    )
    serve.add_argument(
        "--health-interval", type=float, default=2.0, metavar="SECONDS",
        help="cadence of the health/device sampler thread",
    )
    serve.add_argument(
        "--kernel-pack", default=None, metavar="DIR",
        help="prebaked kernel pack (not ported: refused)",
    )
    serve.add_argument(
        "--kernel-cache", default=None, metavar="DIR",
        help="persistent compile-artifact cache (not ported: refused)",
    )
    serve.add_argument(
        "--no-aot", action="store_true",
        help="no AOT export/import (the port has none)",
    )
    serve.add_argument(
        "--router", default=None, metavar="DIR",
        help="learned tier-ladder router artifacts (not ported: refused)",
    )
    serve.add_argument(
        "--no-router", action="store_true",
        help="no learned router tier (the port has none)",
    )
    serve.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="serve on the card (cuda, the default) or the plain PyTorch "
        "versions on the CPU",
    )


def _add_submit(commands) -> None:
    """`submit`: the JAX package's `myth submit` flags."""
    submit = commands.add_parser(
        "submit", help="Submit bytecode to a running `serve` instance"
    )
    submit.add_argument(
        "-c", "--code", metavar="BYTECODE",
        help='hex-encoded bytecode string ("6060604052...")',
    )
    submit.add_argument(
        "-f", "--codefile", metavar="BYTECODEFILE", type=argparse.FileType("r"),
        help="file containing hex-encoded bytecode string",
    )
    submit.add_argument(
        "--url", default="http://127.0.0.1:7341", help="service base URL"
    )
    submit.add_argument(
        "--address", default=None, metavar="ADDRESS",
        help="the deployed code at this address (not ported: refused)",
    )
    submit.add_argument(
        "--rpc-url", default=None, metavar="URL",
        help="execution-client JSON-RPC endpoint for --address",
    )
    submit.add_argument(
        "--max-waves", type=int, default=None, help="device waves override"
    )
    submit.add_argument(
        "--deadline", type=float, default=None,
        help="per-job wall budget the service supervisor enforces",
    )
    submit.add_argument(
        "--no-host-walk", action="store_true", help="ask for a device-only report"
    )
    submit.add_argument(
        "--idempotency-key", default=None, metavar="KEY",
        help="dedupe key for this submission (default: a fresh UUID); a "
        "resubmit with the same key maps to the existing job",
    )
    submit.add_argument(
        "--no-wait", action="store_true",
        help="print the job id and return without waiting for the report",
    )
    submit.add_argument(
        "--wait-s", type=float, default=120.0,
        help="how long to wait for the report",
    )


def serve_refusals(args) -> List[str]:
    """The `serve` settings of modules the port does not have, each
    with the module it needs."""
    import os

    asked = {
        "--devices N > 1": args.devices > 1,
        "--journal": bool(args.journal),
        "--recover": args.recover,
        "--store / MYTHRIL_STORE_DIR": bool(
            args.store or os.environ.get("MYTHRIL_STORE_DIR")
        ) and not args.no_store,
        "--router / MYTHRIL_ROUTER_DIR": bool(
            args.router or os.environ.get("MYTHRIL_ROUTER_DIR")
        ) and not args.no_router,
        "--kernel-pack": bool(args.kernel_pack),
        "--kernel-cache / MYTHRIL_KERNEL_CACHE": bool(
            args.kernel_cache or os.environ.get("MYTHRIL_KERNEL_CACHE")
        ),
    }
    return [
        f"{flag}: needs {module}, which is not ported"
        for flag, module in SERVE_REFUSED
        if asked[flag]
    ]


def run_serve(args) -> int:
    """`serve`: the persistent analysis service until a graceful drain
    (SIGTERM/SIGINT or POST /v1/drain) completes."""
    from mythril_tpu_torch import observe
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import serve_forever
    from mythril_tpu_torch.support.support_args import args as flags

    refused = serve_refusals(args)
    if refused:
        for line in refused:
            print(f"serve: {line}", file=sys.stderr)
        return 2
    if args.no_observe:
        observe.set_enabled(False)
    if args.observe_out:
        observe.configure(out_dir=args.observe_out)
    if args.capture_queries:
        observe.configure_capture(args.capture_queries)
    # the process-wide switches: the host walks in the service pool and
    # the code cache's feeds read the same flag bag
    flags.static_prune = not args.no_static_prune
    flags.blockjit = not args.no_blockjit
    flags.breakers = not args.no_breakers
    config = ServiceConfig(
        stripes=args.stripes,
        lanes_per_stripe=args.lanes_per_stripe,
        steps_per_wave=args.steps_per_wave,
        max_waves=args.max_waves,
        queue_capacity=args.queue_capacity,
        host_workers=args.host_workers,
        host_walk=not args.no_host_walk,
        execution_timeout=args.execution_timeout,
        transaction_count=args.transaction_count,
        checkpoint_dir=args.checkpoint_dir,
        pipeline=False,
        specialize=not args.no_specialize,
        blockjit=not args.no_blockjit,
        static_answer=not (args.no_static_answer or args.no_static_prune),
        arena_warmup=not args.no_arena_warmup,
        health_interval_s=args.health_interval,
        breakers=not args.no_breakers,
        quarantine_strikes=args.quarantine_strikes,
        device=None if args.device == "cuda" else args.device,
    )
    serve_forever(config, host=args.host, port=args.port)
    return 0


def run_submit(args) -> int:
    """`submit`: send bytecode to a running service, print the report
    (or the job id with --no-wait) as JSON."""
    from mythril_tpu_torch.service.client import ServiceClient, ServiceError

    if args.address:
        print(
            "submit: --address needs the chain RPC client "
            "(ethereum/interface/rpc), which is not ported",
            file=sys.stderr,
        )
        return 2
    if args.code:
        blob = args.code
    elif args.codefile:
        blob = "".join(line.strip() for line in args.codefile if line.strip())
    else:
        print(
            "No input bytecode. Provide EVM code via -c BYTECODE or -f "
            "BYTECODE_FILE",
            file=sys.stderr,
        )
        return 1
    client = ServiceClient(args.url)
    try:
        job_id = client.submit(
            blob,
            max_waves=args.max_waves,
            deadline_s=args.deadline,
            host_walk=False if args.no_host_walk else None,
            idempotency_key=args.idempotency_key,
        )
        if args.no_wait:
            print(json.dumps({"job_id": job_id}))
            return 0
        print(json.dumps(client.report(job_id, wait_s=args.wait_s), indent=2))
    except ServiceError as why:
        # backpressure (429 full / 503 draining) and mistakes (400)
        # both land here; the exit code flags the failure for scripts
        print(json.dumps({"error": str(why), "status": why.status}), file=sys.stderr)
        return 1
    return 0


def exit_with_error(format_: str, message: str, exit_code: int = 2) -> None:
    """Print the error in the requested output format and exit (the JAX
    package's exit_with_error, with a nonzero code)."""
    if format_ in ("text", "markdown"):
        print(message, file=sys.stderr)
    elif format_ == "json":
        print(json.dumps({"success": False, "error": message, "issues": []}))
    else:
        print(json.dumps([{
            "issues": [],
            "sourceType": "",
            "sourceFormat": "",
            "sourceList": [],
            "meta": {"logs": [{"level": "error", "hidden": True, "msg": message}]},
        }]))
    sys.exit(exit_code)


def load_codes(args) -> List[Tuple[str, str]]:
    """(name, runtime hex) for each input: `-c` or a single `-f` is
    "MAIN", as in the JAX package; a corpus of files is named by path."""
    blobs = []
    if args.code:
        blobs.append(("MAIN", args.code))
    for f in args.codefile or []:
        blobs.append((f.name, "".join(line.strip() for line in f if line.strip())))
    if len(blobs) == 1:
        blobs = [("MAIN", blobs[0][1])]
    return [(name, code[2:] if code.startswith("0x") else code) for name, code in blobs]


def input_refusals(args) -> List[str]:
    """The inputs of the JAX command the port cannot load, each with
    what it needs."""
    asked = [
        ("Solidity input files", bool(getattr(args, "solidity_files", None)), NO_SOLC),
        ("--truffle", getattr(args, "truffle", False), NO_SOLC),
        ("--solv / --solc-json", bool(args.solv or args.solc_json), NO_SOLC),
        ("-a / --address", bool(args.address), NO_RPC),
        ("--rpc", bool(args.rpc), NO_RPC),
        ("--infura-id", bool(getattr(args, "infura_id", None)), NO_RPC),
    ]
    return [f"{flag}: needs {needs}" for flag, on, needs in asked if on]


def analyze_refusals(args) -> List[str]:
    """`analyze`'s flags whose modules the port does not have, each with
    what it needs; the inputs' refusals first."""
    import os

    asked = [
        ("--devices N > 1", (args.devices or 1) > 1,
         "the device mesh (parallel/mesh.py, topology.py), which is not ported"),
        ("--store / MYTHRIL_STORE_DIR",
         bool(args.store or os.environ.get("MYTHRIL_STORE_DIR")) and not args.no_store,
         "the verdict store (store/store.py), which is not ported"),
        ("--host-first-funnel", args.host_first_funnel,
         "the host-first solver funnel, which is not in the port's explorer"),
        ("--sparse-pruning", args.sparse_pruning,
         "its branch of the host walk (laser/ethereum/svm.py), which is not in "
         "the port"),
        ("--unconstrained-storage", args.unconstrained_storage,
         "its branch of the host walk (laser/ethereum/state/account.py), which "
         "is not in the port"),
        ("-q / --query-signature", args.query_signature,
         "the online signature lookup (www.4byte.directory), which needs the "
         "network and is not ported"),
        ("--no-static-answer", args.no_static_answer,
         "the static-answer triage tier, which is not in the port's analyzer "
         "facade (it walks every contract): only "
         "analysis/corpus.py:analyze_corpus has it"),
    ]
    return input_refusals(args) + [
        f"{flag}: needs {needs}" for flag, on, needs in asked if on
    ]


def load_bytecode(disassembler, args, outform: str) -> str:
    """Load every -c/-f input through the disassembler (the JAX
    `load_code`); the address to analyze at. `-c` or a single `-f` is
    "MAIN", as in the JAX package; each file of a corpus is named by its
    path."""
    codes = load_codes(args)
    if not codes:
        exit_with_error(
            outform,
            "No input bytecode. Please provide EVM runtime code via -c "
            "BYTECODE or -f BYTECODE_FILE, with --bin-runtime",
        )
    address = None
    for name, code in codes:
        address, contract = disassembler.load_from_bytecode(code, args.bin_runtime)
        contract.name = name
    return address


def _override_actors(args) -> None:
    """--attacker-address / --creator-address into ACTORS (the JAX
    `_override_actors`)."""
    from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS

    for flag, actor in (
        ("attacker_address", "ATTACKER"),
        ("creator_address", "CREATOR"),
    ):
        given = getattr(args, flag)
        if not given:
            continue
        try:
            ACTORS[actor] = given
        except ValueError:
            exit_with_error(args.outform, f"{actor.capitalize()} address is invalid")


def _apply_corpus_shard(disassembler, args) -> bool:
    """--corpus-shard I/N: keep only this host's content-hash shard of
    the loaded contracts (analysis/corpus.py corpus_shard). True when
    sharding emptied a previously NON-empty contract list."""
    from mythril_tpu_torch.analysis.corpus import corpus_shard

    spec = args.corpus_shard
    if not spec or not disassembler.contracts:
        return False
    try:
        index_s, count_s = spec.split("/", 1)
        index, count = int(index_s), int(count_s)
    except ValueError:
        exit_with_error(args.outform, f"--corpus-shard wants I/N, got {spec!r}")
    try:
        disassembler.contracts[:] = corpus_shard(
            disassembler.contracts,
            index,
            count,
            identity=lambda c: f"{c.name}:{c.code or ''}",
        )
    except ValueError as why:
        exit_with_error(args.outform, str(why))
    return not disassembler.contracts


def _render(report, outform: str) -> str:
    return {
        "json": report.as_json,
        "jsonv2": report.as_swc_standard_format,
        "text": report.as_text,
        "markdown": report.as_markdown,
    }[outform]()


def _write_artifact(outform: str, path: str, text: str, what: str) -> None:
    try:
        with open(path, "w") as fp:
            fp.write(text)
    except OSError as e:
        exit_with_error(outform, f"Error saving {what}: {e}")


def run_analyze(args) -> int:
    """`analyze`, as the JAX `_run_analyze`: the contracts through
    MythrilDisassembler, then MythrilAnalyzer's statespace (-j), graph
    (-g) or `fire_lasers`, whose report prints in the asked form."""
    from mythril_tpu_torch.analysis.report import Report
    from mythril_tpu_torch.exceptions import DeadlineExpiredError, DetectorNotFoundError
    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.support import resilience

    refused = analyze_refusals(args)
    if refused:
        for line in refused:
            print(f"analyze: {line}", file=sys.stderr)
        return 2
    if not args.bin_runtime:
        exit_with_error(
            args.outform,
            "the port analyzes runtime code: pass runtime bytecode with "
            "--bin-runtime",
        )
    disassembler = MythrilDisassembler()
    address = load_bytecode(disassembler, args, args.outform)
    if _apply_corpus_shard(disassembler, args):
        # a legitimately empty shard (more hosts than contracts) is a
        # clean no-findings run, in the asked form
        print(_render(Report(), args.outform))
        return 0
    analyzer = MythrilAnalyzer(
        strategy=args.strategy,
        disassembler=disassembler,
        address=address,
        max_depth=args.max_depth,
        execution_timeout=args.execution_timeout,
        loop_bound=args.loop_bound,
        create_timeout=args.create_timeout,
        enable_iprof=args.enable_iprof,
        disable_dependency_pruning=args.disable_dependency_pruning,
        use_onchain_data=not args.no_onchain_data,
        solver_timeout=args.solver_timeout,
        parallel_solving=args.parallel_solving,
        custom_modules_directory=args.custom_modules_directory or "",
        call_depth_limit=args.call_depth_limit,
        device_prepass=args.device_prepass,
        device_solving=args.device_solving,
        device_prepass_budget=args.device_prepass_budget,
        device_ownership=args.device_ownership,
        deterministic_solving=args.deterministic_solving,
        static_prune=not args.no_static_prune,
        specialize=not args.no_specialize,
        blockjit=not args.no_blockjit,
        deadline=args.deadline,
        on_timeout=args.on_timeout,
        capture_queries=args.capture_queries,
        sprint_cap_s=args.sprint_cap_s,
        device=None if args.device == "cuda" else args.device,
    )
    _override_actors(args)
    if args.graph:
        html = analyzer.graph_html(
            contract=analyzer.contracts[0],
            enable_physics=args.enable_physics,
            phrackify=args.phrack,
            transaction_count=args.transaction_count,
        )
        _write_artifact(args.outform, args.graph, html, "graph")
        return 0
    if args.statespace_json:
        statespace = analyzer.dump_statespace(contract=analyzer.contracts[0])
        _write_artifact(args.outform, args.statespace_json, json.dumps(statespace), "json")
        return 0
    marker = resilience.DegradationLog().marker()
    try:
        report = analyzer.fire_lasers(
            modules=(
                [m.strip() for m in args.modules.strip().split(",")]
                if args.modules
                else None
            ),
            transaction_count=args.transaction_count,
        )
    except DetectorNotFoundError as e:
        exit_with_error(args.outform, format(e))
    except DeadlineExpiredError as e:
        # --on-timeout=fail: the budget is a hard contract, and the exit
        # code says so (scripts gate on it)
        exit_with_error(args.outform, "Analysis deadline expired: " + format(e), exit_code=1)
    status = (report.degradation or {}).get("contracts", [])
    crashed = [c["contract"] for c in status if not c["complete"] and not c.get("skipped")]
    errors = [f"{name}: {why}" for name, why in zip(crashed, report.exceptions)] + [
        f"{c['contract']}: skipped: {c['skipped']}" for c in status if c.get("skipped")
    ]
    if errors and args.outform in ("text", "markdown"):
        # the templates' clean message ("completed successfully") must
        # not stand for a run that left contracts unanalyzed
        if report.issues:
            print(_render(report, args.outform))
        print(
            f"The analysis is incomplete: {len(errors)} of {len(status)} "
            "contract(s) were not analyzed.\n" + "\n".join(errors)
        )
    else:
        print(_render(report, args.outform))
    for error in errors:
        print(error, file=sys.stderr)
    # a degradation (a failed race launch among them) shows in every
    # output form, not only in the json reports' `degradation` field
    for reason, count in sorted(resilience.DegradationLog().counts_since(marker).items()):
        print(f"degraded: {reason} x{count}", file=sys.stderr)
    # a walk that raised leaves its contract unanalyzed: exit 1; contracts
    # a --deadline skipped make a partial report, exit 0
    return 1 if crashed else 0


def run_disassemble(args) -> int:
    """`disassemble`: the first contract's easm, as the JAX command
    prints it."""
    from mythril_tpu_torch.mythril import MythrilDisassembler

    refused = input_refusals(args)
    if refused:
        for line in refused:
            print(f"disassemble: {line}", file=sys.stderr)
        return 2
    disassembler = MythrilDisassembler()
    load_bytecode(disassembler, args, "text")
    target = disassembler.contracts[0]
    if target.code:
        print("Runtime Disassembly: \n" + target.get_easm())
    if target.creation_code:
        print("Disassembly: \n" + target.get_creation_easm())
    return 0


def run_list_detectors(args) -> int:
    from mythril_tpu_torch.analysis.module import ModuleLoader

    rows = [
        {"classname": type(module).__name__, "title": module.name}
        for module in ModuleLoader().get_detection_modules()
    ]
    if args.outform == "json":
        print(json.dumps(rows))
    else:
        for row in rows:
            print("{}: {}".format(row["classname"], row["title"]))
    return 0


def run_version(args) -> int:
    from mythril_tpu_torch import __version__

    if args.outform == "json":
        print(json.dumps({"version_str": __version__}))
    else:
        print("Mythril-TPU version {}".format(__version__))
    return 0


def run_lint(args) -> int:
    """The static layer alone: per contract, CFG and prune statistics
    plus the static findings (the JAX `myth lint` rows, `schema_version`
    pins the payload). Never touches the card."""
    from mythril_tpu_torch.analysis.static import LINT_CHECKS, summary_for

    fail_on = set(args.fail_on or [])
    unknown_checks = fail_on - LINT_CHECKS
    if unknown_checks:
        exit_with_error(
            args.outform,
            "unknown --fail-on check(s): {} (known: {})".format(
                ", ".join(sorted(unknown_checks)), ", ".join(sorted(LINT_CHECKS))
            ),
            exit_code=2,
        )
    codes = load_codes(args)
    if not codes:
        exit_with_error(
            args.outform,
            "No input bytecode. Please provide EVM bytecode via -c BYTECODE "
            "or -f BYTECODE_FILE",
        )
    rows = []
    for name, code in codes:
        try:
            summary = summary_for(code)
        except Exception as why:
            exit_with_error(
                args.outform, f"static analysis failed for {name}: {why}", exit_code=1
            )
        rows.append(summary.lint_dict(name=name))
    fired = sorted(
        {
            finding["check"]
            for row in rows
            for finding in row["findings"]
            if finding["check"] in fail_on
        }
    )
    if args.outform in ("json", "jsonv2"):
        print(json.dumps(rows, sort_keys=True))
        return 1 if fired else 0
    for row in rows:
        print(lint_text(row))
    if fired:
        print("lint: --fail-on check(s) fired: {}".format(", ".join(fired)))
        return 1
    return 0


def lint_text(row: dict) -> str:
    """One contract's lint row as the JAX `myth lint` prints it."""
    lines = [
        f"Static analysis: {row['contract']} ({row['code_hash']})",
        "  blocks: {blocks} ({reachable_blocks} reachable, {dead_blocks} dead), "
        "instructions: {instructions} ({dead_instructions} dead)".format(**row),
        "  jumps: {resolved_jumps} resolved / {unresolved_jumps} unresolved / "
        "{invalid_jumps} invalid; dead branch directions: "
        "{dead_directions}".format(**row),
        "  selectors: {selectors} ({dead_selectors} statically prunable); "
        "prune rate: {prune_rate}".format(**row),
    ]
    skipped = row["modules_skipped"]
    lines.append(
        "  detector screen: {} applicable, {} skipped{}".format(
            row["modules_applicable"],
            len(skipped),
            " ({})".format(", ".join(skipped)) if skipped else "",
        )
    )
    taint = row.get("taint") or {}
    if taint and not taint.get("incomplete"):
        lines.append(
            "  taint: density {density}, {n_calls} resolved call target(s), "
            "{n_fp} function fingerprint(s){answer}".format(
                density=taint.get("density"),
                n_calls=row.get("resolved_call_target_count", 0),
                n_fp=row.get("fingerprint_count", 0),
                answer="; statically answerable" if row.get("static_answerable") else "",
            )
        )
    if row["findings"]:
        lines.append("  findings:")
        lines.extend("    - [{check}] {detail}".format(**f) for f in row["findings"])
    lines.append("  wall: {wall_ms} ms".format(**row))
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command in UNPORTED_COMMAND_NEEDS:
        print(f"{args.command}: needs {UNPORTED_COMMAND_NEEDS[args.command]}",
              file=sys.stderr)
        return 2
    if args.command == "function-to-hash":
        from mythril_tpu_torch.mythril import MythrilDisassembler

        print(MythrilDisassembler.hash_for_function_signature(args.func_name))
        return 0
    if args.command == "version":
        return run_version(args)
    if args.command == "list-detectors":
        return run_list_detectors(args)
    if args.command in ("disassemble", "d"):
        return run_disassemble(args)
    if args.command == "lint":
        return run_lint(args)
    if args.command == "serve":
        logging.basicConfig(level=logging.WARNING)
        return run_serve(args)
    if args.command == "submit":
        return run_submit(args)
    if args.command not in ANALYZE_LIST:
        parser.print_help()
        return 2
    logging.basicConfig(level=logging.WARNING)
    return run_analyze(args)
