"""Legacy standalone instruction profiler (reference:
mythril/laser/ethereum/iprof.py:27-79) — same statistics as the
instruction-profiler plugin, driven via `args.iprof`."""

from __future__ import annotations

from collections import namedtuple
from datetime import datetime
from typing import Dict, List

Record = namedtuple("Record", ["op_code", "start_time", "end_time"])


class InstructionProfiler:
    """Measures min/max/avg execution time per opcode."""

    def __init__(self):
        self.records: Dict[str, List[Record]] = {}
        self.start_time = None

    def start(self, op_code: str) -> None:
        self.start_time = datetime.now()

    def end(self, op_code: str) -> None:
        end = datetime.now()
        self.records.setdefault(op_code, []).append(
            Record(op_code, self.start_time, end)
        )

    def __str__(self) -> str:
        out = []
        total = 0.0
        for op, recs in sorted(self.records.items()):
            times = [
                (r.end_time - r.start_time).total_seconds() for r in recs
            ]
            total += sum(times)
            out.append(
                "[{:12s}] nr {:>6}, total {:>8.4f} s, avg {:>8.4f} s,"
                " min {:>8.4f} s, max {:>8.4f} s".format(
                    op, len(times), sum(times), sum(times) / len(times),
                    min(times), max(times),
                )
            )
        return "Total: {:.4f} s\n".format(total) + "\n".join(out)
