"""`python -m mythril_tpu_torch analyze`: runtime bytecode in, the JAX
package's `Report` out.

A thin counterpart of the JAX package's `myth analyze`
(interfaces/cli.py) with the flags of its device path: the bytecode
(`-c`, or `-f` once per contract of a corpus) goes through one striped
exploration on the card, the ownership gate and issue synthesis
(analysis/corpus.py:analyze_corpus), and the report prints as text,
markdown, json or jsonv2.

The port has no host engine, so:

- creation bytecode, which needs the host's create transaction, is
  refused: pass runtime bytecode with `--bin-runtime`;
- a contract the device does not own is not analyzed. The report says
  so (json and jsonv2 carry `partial` and the per-contract status; text
  and markdown end with the contracts not analyzed, in place of the
  templates' "completed successfully"; every form prints the reasons on
  stderr) and the command exits with 1.

`--device cuda` (the default) runs on the card and raises where there is
none; `--device cpu` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Tuple

ANALYZE_LIST = ("analyze", "a")
OUTFORMS = ("text", "markdown", "json", "jsonv2")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m mythril_tpu_torch",
        description="Security analysis of EVM runtime bytecode on the card",
    )
    commands = parser.add_subparsers(dest="command")
    analyze = commands.add_parser(
        "analyze", aliases=["a"], help="analyze runtime bytecode"
    )
    analyze.add_argument(
        "-c", "--code", metavar="BYTECODE",
        help='hex-encoded bytecode string ("6060604052...")',
    )
    analyze.add_argument(
        "-f", "--codefile", metavar="BYTECODEFILE", action="append",
        type=argparse.FileType("r"),
        help="file containing hex-encoded bytecode; repeat for a corpus",
    )
    analyze.add_argument(
        "--bin-runtime", action="store_true",
        help="consider the input bytecode as runtime code (required: "
        "creation bytecode needs the host engine, which is not ported)",
    )
    analyze.add_argument(
        "-o", "--outform", choices=OUTFORMS, default="text",
        metavar="<text/markdown/json/jsonv2>", help="report output format",
    )
    analyze.add_argument(
        "-t", "--transaction-count", type=int, default=2,
        help="Maximum number of transactions issued by laser",
    )
    analyze.add_argument(
        "--execution-timeout", type=int, default=86400,
        help="The amount of seconds to spend on symbolic execution (sizes "
        "the device prepass budget)",
    )
    analyze.add_argument(
        "--device-ownership", choices=["auto", "never"], default="auto",
        help="Let the device OWN contracts its exploration covered end to "
        "end (auto); never needs the host walk, which is not ported",
    )
    analyze.add_argument(
        "--parallel-solving", action="store_true",
        help="Enable solving solver queries in parallel (a query the CDCL "
        "leaves unknown gets one portfolio search where the analysis runs)",
    )
    analyze.add_argument(
        "--deterministic-solving", action="store_true",
        help="Conflict-budget solver marathons so reports are reproducible "
        "across machines and load (slightly less complete on hard queries "
        "than pure wall budgets)",
    )
    analyze.add_argument(
        "--sprint-cap-s", type=float, default=None, metavar="SECONDS",
        help="Wall cap for the escalation ladder's host-CDCL pass over one "
        "wave's flip survivors (default 5.0; 0 defers every survivor); "
        "capped queries are recorded SPRINT_PREEMPTED and retried next wave",
    )
    analyze.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="run on the card (cuda, the default) or the plain PyTorch "
        "versions on the CPU",
    )
    return parser


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


def build_report(contracts, results, degradation_marker):
    """The JAX package's Report over the owned contracts' issues, with
    the per-contract status and the unanalyzed contracts' reasons."""
    from mythril_tpu_torch.analysis.report import Report
    from mythril_tpu_torch.support.resilience import DegradationLog

    errors = [
        f"{r['name']}: {r.get('error') or 'skipped: ' + str(r.get('skipped'))}"
        for r in results
        if not r["complete"]
    ]
    report = Report(contracts=contracts, exceptions=errors)
    for contract, result in zip(contracts, results):
        for issue in result["issue_objects"]:
            issue.add_code_info(contract)
            report.append_issue(issue)
    completion = [
        {
            "contract": r["name"],
            "complete": r["complete"],
            "device_complete": r["device_complete"],
            "owned": bool(r.get("owned")),
            **({"skipped": r["skipped"]} if r.get("skipped") else {}),
        }
        for r in results
    ]
    reasons = DegradationLog().counts_since(degradation_marker)
    if errors or reasons:
        report.partial = bool(errors)
        report.degradation = {"reasons": reasons, "contracts": completion}
    return report, errors


def run_analyze(args) -> int:
    from mythril_tpu_torch.analysis.corpus import analyze_corpus
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.support import resilience
    from mythril_tpu_torch.support.accel import resolve_device
    from mythril_tpu_torch.support.start_time import StartTime
    from mythril_tpu_torch.support.support_args import args as flags

    codes = load_codes(args)
    if not codes:
        exit_with_error(
            args.outform,
            "No input bytecode. Please provide EVM runtime code via -c "
            "BYTECODE or -f BYTECODE_FILE, with --bin-runtime",
        )
    if not args.bin_runtime:
        exit_with_error(
            args.outform,
            "creation bytecode needs the host engine's create transaction, "
            "which is not ported: pass runtime bytecode with --bin-runtime",
        )
    device = resolve_device(None if args.device == "cuda" else args.device)
    flags.device_ownership = args.device_ownership
    flags.parallel_solving = args.parallel_solving
    flags.deterministic_solving = args.deterministic_solving
    if args.sprint_cap_s is not None:
        flags.sprint_cap_s = args.sprint_cap_s
    StartTime()
    contracts = [EVMContract(code=code, name=name) for name, code in codes]
    marker = resilience.DegradationLog().marker()
    with resilience.graceful_shutdown():
        results = analyze_corpus(
            [(c.code, "", c.name) for c in contracts],
            transaction_count=args.transaction_count,
            execution_timeout=args.execution_timeout,
            device=device,
        )
    report, errors = build_report(contracts, results, marker)
    render = {
        "json": report.as_json,
        "jsonv2": report.as_swc_standard_format,
        "text": report.as_text,
        "markdown": report.as_markdown,
    }[args.outform]
    if errors and args.outform in ("text", "markdown"):
        # the templates' clean message ("completed successfully") must
        # not stand for a run that left contracts unanalyzed
        if report.issues:
            print(render())
        print(
            f"The analysis is incomplete: {len(errors)} of {len(results)} "
            "contract(s) were not analyzed.\n" + "\n".join(errors)
        )
    else:
        print(render())
    for error in errors:
        print(error, file=sys.stderr)
    # a degradation (a failed race launch among them) shows in every
    # output form, not only in the json reports' `degradation` field
    for reason, count in sorted(resilience.DegradationLog().counts_since(marker).items()):
        print(f"degraded: {reason} x{count}", file=sys.stderr)
    return 1 if errors else 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command not in ANALYZE_LIST:
        parser.print_help()
        return 2
    logging.basicConfig(level=logging.WARNING)
    return run_analyze(args)
