"""Ethereum VMTests conformance: batched concrete replay on the port.

The official Ethereum VMTests (vendored under
tests/testdata/vendored/VMTests, public consensus test vectors) are
replayed as ONE StateBatch: every test is a lane, the step advances all
of them together, and verdicts are read back from the final batch
(post-storage, output, gas bounds), as the JAX package's
laser/conformance.py does. With `hybrid` (the default), lanes the
device cannot finish (UNSUPPORTED, memory capacity) are lifted mid-frame
into the host engine (laser/batch/takeover.py) and judged on the
continued execution; without it they are judged "skip".
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.interop import batch_to_numpy
from mythril_tpu_torch.laser.batch.run import run
from mythril_tpu_torch.laser.batch.state import (
    CALLDATA_CAP,
    STORAGE_CAP,
    StateBatch,
    Status,
    batch_from_fields,
    make_batch_numpy,
    make_code_table,
    mem_bytes,
    storage_dict,
)
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.support.accel import resolve_device

VMTESTS_ROOT = (
    Path(__file__).resolve().parents[2] / "tests" / "testdata" / "vendored" / "VMTests"
)

SUITES = [
    "vmArithmeticTest",
    "vmBitwiseLogicOperation",
    "vmEnvironmentalInfo",
    "vmPushDupSwapTest",
    "vmTests",
    "vmSha3Test",
    "vmSystemOperations",
    "vmRandomTest",
    "vmIOandFlowOperations",
]

# Name-based skips: fixtures disputed upstream
SKIP_NAMES = {
    "jumpTo1InstructionafterJump": "fixture oddity (reference tests_to_resolve)",
    "sstore_load_2": "fixture oddity (reference tests_to_resolve)",
}

CODE_CAP = 8192  # max bytecode bytes handled by the conformance batch


class VmTest(NamedTuple):
    name: str  # unique key "<suite>/<test>" (a few raw names repeat)
    suite: str
    code: bytes
    calldata: bytes
    value: int
    caller: int
    origin: int
    gasprice: int
    gas: int
    address: int
    balance: int
    pre_storage: dict
    post_storage: Optional[dict]  # None => exceptional halt expected
    check_storage: bool  # exec account present in post?
    out: bytes
    gas_used: Optional[int]
    coinbase: int
    difficulty: int
    gaslimit: int
    number: int
    timestamp: int
    #: a pre-state account other than the exec target carries code, so
    #: device lanes must not treat calls as empty-world transfers
    foreign_code: bool
    #: those accounts: ((address, code_hex, balance, ((slot, value), ...)), ...)
    foreign_accounts: tuple


def _hx(s: str) -> int:
    return int(s, 16)


def _hb(s: str) -> bytes:
    s = s[2:] if s.startswith("0x") else s
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


def load_vmtests(root: Path = VMTESTS_ROOT, suites=None):
    """Load test cases. Returns (cases, skipped) where skipped is a list
    of (name, reason) for tests this batch model cannot represent."""
    cases, skipped = [], []
    for suite in suites or SUITES:
        d = Path(root) / suite
        if not d.is_dir():
            continue
        for f in sorted(d.iterdir()):
            if f.suffix != ".json":
                continue
            with f.open() as fh:
                fixtures = json.load(fh)
            for name, data in fixtures.items():
                ex = data["exec"]
                code = _hb(ex["code"])
                calldata = _hb(ex.get("data", "0x"))
                addr = _hx(ex["address"])
                pre = data.get("pre", {})
                pre_acct = next(
                    (v for k, v in pre.items() if _hx(k) == addr), {})
                pre_storage = {
                    _hx(k): _hx(v)
                    for k, v in pre_acct.get("storage", {}).items()
                }
                if name in SKIP_NAMES:
                    skipped.append((name, SKIP_NAMES[name]))
                    continue
                if len(code) > CODE_CAP:
                    skipped.append((name, f"code > {CODE_CAP}B cap"))
                    continue
                if len(calldata) > CALLDATA_CAP:
                    skipped.append((name, f"calldata > {CALLDATA_CAP}B cap"))
                    continue
                if len(pre_storage) > STORAGE_CAP:
                    skipped.append((name, "pre-storage > journal cap"))
                    continue
                post = data.get("post")
                post_storage = None
                check_storage = False
                if post is not None:
                    post_acct = next(
                        (v for k, v in post.items() if _hx(k) == addr), None)
                    check_storage = post_acct is not None
                    post_storage = {
                        _hx(k): _hx(v)
                        for k, v in (post_acct or {}).get("storage", {}).items()
                        if _hx(v) != 0
                    }
                gas = _hx(ex["gas"])
                gas_after = data.get("gas")
                env = data.get("env", {})
                foreign_accounts = tuple(
                    (
                        _hx(k),
                        v.get("code", "0x")[2:],
                        _hx(v.get("balance", "0x0")),
                        tuple(
                            (_hx(sk), _hx(sv))
                            for sk, sv in v.get("storage", {}).items()
                        ),
                    )
                    for k, v in pre.items()
                    if _hx(k) != addr
                )
                cases.append(VmTest(
                    name=f"{suite}/{name}",
                    suite=suite,
                    code=code,
                    calldata=calldata,
                    value=_hx(ex.get("value", "0x0")),
                    caller=_hx(ex["caller"]),
                    origin=_hx(ex["origin"]),
                    gasprice=_hx(ex.get("gasPrice", "0x0")),
                    gas=gas,
                    address=addr,
                    balance=_hx(pre_acct.get("balance", "0x0")),
                    pre_storage=pre_storage,
                    post_storage=post_storage,
                    check_storage=check_storage,
                    out=_hb(data.get("out", "0x")),
                    gas_used=(gas - _hx(gas_after)) if gas_after else None,
                    coinbase=_hx(env.get("currentCoinbase", "0x0")),
                    difficulty=_hx(env.get("currentDifficulty", "0x0")),
                    gaslimit=_hx(env.get("currentGasLimit", "0x0")),
                    number=_hx(env.get("currentNumber", "0x0")),
                    timestamp=_hx(env.get("currentTimestamp", "0x0")),
                    foreign_code=any(acct[1] for acct in foreign_accounts),
                    foreign_accounts=foreign_accounts,
                ))
    return cases, skipped


def _rows(vals):
    return np.stack([u256.from_int(v) for v in vals])


def build_batch(cases, device=None):
    """One lane per test case; one shared CodeTable row per case. On the
    card unless `device` names another."""
    device = resolve_device(device)
    n = len(cases)
    code_table = make_code_table([c.code for c in cases], code_cap=CODE_CAP,
                                 device=device)
    fields = make_batch_numpy(
        n,
        code_ids=np.arange(n, dtype=np.int32),
        calldata=[c.calldata for c in cases],
        stack_cap=1024,  # the real EVM stack limit
        empty_world=np.array([not c.foreign_code for c in cases], dtype=np.uint8),
    )
    skeys = np.zeros((n, STORAGE_CAP, u256.LIMBS), dtype=np.uint32)
    svals = np.zeros_like(skeys)
    scnt = np.zeros((n,), dtype=np.int32)
    for i, c in enumerate(cases):
        for j, (k, v) in enumerate(c.pre_storage.items()):
            skeys[i, j] = u256.from_int(k)
            svals[i, j] = u256.from_int(v)
        scnt[i] = len(c.pre_storage)
    fields = fields._replace(
        address=_rows([c.address for c in cases]),
        caller=_rows([c.caller for c in cases]),
        origin=_rows([c.origin for c in cases]),
        callvalue=_rows([c.value for c in cases]),
        gasprice=_rows([c.gasprice for c in cases]),
        balance=_rows([c.balance for c in cases]),
        coinbase=_rows([c.coinbase for c in cases]),
        difficulty=_rows([c.difficulty for c in cases]),
        gaslimit=_rows([c.gaslimit for c in cases]),
        number=_rows([c.number for c in cases]),
        timestamp=_rows([c.timestamp for c in cases]),
        gas_budget=np.minimum([c.gas for c in cases], 2**32 - 1).astype(np.uint32),
        storage_keys=skeys,
        storage_vals=svals,
        storage_cnt=scnt,
    )
    return batch_from_fields(fields, device), code_table


_FAIL_STATUSES = {
    Status.REVERTED, Status.INVALID, Status.ERR_STACK, Status.ERR_JUMP,
    Status.ERR_MEM, Status.ERR_OOG,
}


def _verdict(case: VmTest, batch, lane: int) -> str:
    """Judge one lane of a host (numpy) final batch against its fixture."""
    st = int(batch.status[lane])
    if st == Status.UNSUPPORTED:
        return "skip: opcode outside device set"
    if st == Status.RUNNING:
        return "skip: step budget exhausted"
    if case.post_storage is None:
        # exceptional halt expected (no post section in the fixture)
        if st in _FAIL_STATUSES:
            return "pass"
        return f"fail: completed (status {st}) but exceptional halt expected"
    if st == Status.ERR_MEM:
        return "skip: memory model capacity"
    if st not in (Status.STOPPED, Status.RETURNED, Status.KILLED):
        return f"fail: status {st}, success expected"
    if case.check_storage:
        got = storage_dict(batch, lane)
        if got != case.post_storage:
            diff_keys = set(got) ^ set(case.post_storage)
            diff_keys |= {
                k for k in set(got) & set(case.post_storage)
                if got[k] != case.post_storage[k]
            }
            return f"fail: storage mismatch at slots {sorted(diff_keys)[:4]}"
    got_out = b""
    if st == Status.RETURNED:
        got_out = mem_bytes(
            batch, lane, int(batch.ret_offset[lane]), int(batch.ret_len[lane]))
    if got_out != case.out:
        return f"fail: out mismatch ({got_out.hex()[:32]} != {case.out.hex()[:32]})"
    if case.gas_used is not None:
        gmin, gmax = int(batch.gas_min[lane]), int(batch.gas_max[lane])
        if not gmin <= case.gas_used <= gmax:
            return (f"fail: gas bounds [{gmin}, {gmax}] exclude "
                    f"actual gas used {case.gas_used}")
    return "pass"


#: second-pass step budget for lanes still running after the main run:
#: the forever-OOG fixtures halt by gas exhaustion, not by fixpoint
STRAGGLER_STEPS = 1 << 17


def _host_verdict(case: VmTest, outcome: dict) -> str:
    """Judge a host-takeover continuation against the fixture."""
    if case.post_storage is None:
        return (
            "pass"
            if not outcome["open"]
            else "fail: completed on host but exceptional halt expected"
        )
    if not outcome["open"]:
        return "fail: host continuation halted exceptionally"
    if case.check_storage and outcome["storage"] != case.post_storage:
        return "fail: storage mismatch after host takeover"
    if outcome["out"] != case.out:
        return "fail: out mismatch after host takeover"
    if case.gas_used is not None:
        if not any(lo <= case.gas_used <= hi for lo, hi in outcome["gas_bounds"]):
            return "fail: gas bounds exclude actual after host takeover"
    return "pass"


def run_cases(cases, max_steps: int = 4096, hybrid: bool = True,
              straggler_steps: int = STRAGGLER_STEPS, device=None):
    """Run every case in one batch on `device` (the card unless named);
    return {name: verdict}.

    Lanes still RUNNING after the main pass run on from there, up to
    `straggler_steps` in all, when that is larger than `max_steps` (the
    JAX package re-runs them from the start: the same final state). With
    `hybrid`, lanes the device cannot finish (UNSUPPORTED / capacity)
    are lifted mid-frame into the host engine and judged on the
    continued execution instead of skipping (takeover.py)."""
    device = resolve_device(device)
    batch, code_table = build_batch(cases, device=device)
    out, _ = run(batch, code_table, max_steps=max_steps, track_coverage=False)
    final = batch_to_numpy(out)  # one bulk read; verdicts index numpy
    lanes = {i: (final, i) for i in range(len(cases))}

    stragglers = [i for i in range(len(cases))
                  if int(final.status[i]) == Status.RUNNING]
    if stragglers and straggler_steps > max_steps:
        # the stragglers go on from where the main pass left them: lanes
        # step independently, so this is the state a run of
        # `straggler_steps` from the start reaches, less the first
        # `max_steps` steps run again
        idx = torch.tensor(stragglers, device=device)
        long_run, _ = run(StateBatch(*(t.index_select(0, idx) for t in out)), code_table,
                          max_steps=straggler_steps - max_steps, track_coverage=False)
        long_run = batch_to_numpy(long_run)
        for j, i in enumerate(stragglers):
            lanes[i] = (long_run, j)

    verdicts = {}
    for i, c in enumerate(cases):
        view, lane = lanes[i]
        verdict = _verdict(c, view, lane)
        if hybrid and int(view.status[lane]) in (Status.UNSUPPORTED, Status.ERR_MEM):
            from mythril_tpu_torch.laser.batch.takeover import resume_on_host

            outcome = resume_on_host(
                c.code.hex(),
                view,
                lane,
                extra_accounts=[
                    (addr, code, bal, dict(slots))
                    for addr, code, bal, slots in c.foreign_accounts
                ],
            )
            if outcome is not None:
                verdict = _host_verdict(c, outcome)
        verdicts[c.name] = verdict
    return verdicts
