"""The port's host LASER engine against its batched interpreter and the
JAX package's host takeover, on the CPU.

- Engine differential: tests/laser/test_engine_differential.py's random
  straight-line, memory/SHA3 and branch programs (the same seeds) run
  through the port's `LaserEVM` (concolic message call) and the port's
  `laser/batch/run.py` as lanes of one batch; the final storage agrees.
- Host takeover: a VMTests lane the device halts UNSUPPORTED
  (vmSha3Test/sha3_bigOffset2) is lifted by the port's
  `takeover.lift_lane` and by the JAX package's from the same final
  batch (the port's run, carried to the JAX package's numpy layout by
  `interop.batch_to_numpy`): the lifted states are equal field by field,
  and both continuations end the same. The hybrid replay
  (`run_cases(hybrid=True)`) turns the lane's skip into a pass.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import conformance as tconf
from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
from mythril_tpu_torch.laser.batch import takeover as port_takeover
from mythril_tpu_torch.laser.batch.state import Status, storage_dict
from mythril_tpu_torch.laser.smt import symbol_factory

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "test_engine_differential", TESTS / "laser" / "test_engine_differential.py")
DIFF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DIFF)

TAKEOVER_CASE = "vmSha3Test/sha3_bigOffset2"


def run_port_laser(code: bytes) -> dict:
    """tests/laser/test_engine_differential.py:run_laser over the port's
    engine."""
    from datetime import datetime

    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.laser.ethereum.state.account import Account
    from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
    from mythril_tpu_torch.laser.ethereum.svm import LaserEVM
    from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
    from mythril_tpu_torch.laser.ethereum.transaction.concolic import execute_message_call

    world_state = WorldState()
    account = Account(DIFF.ADDRESS, concrete_storage=True)
    account.code = Disassembly(code.hex())
    world_state.put_account(account)
    account.set_balance(10**18)
    time_handler.start_execution(10000)
    laser = LaserEVM()
    laser.open_states = [world_state]
    laser.time = datetime.now()
    execute_message_call(
        laser,
        callee_address=symbol_factory.BitVecVal(DIFF.ADDRESS, 256),
        caller_address=symbol_factory.BitVecVal(DIFF.CALLER, 256),
        origin_address=symbol_factory.BitVecVal(DIFF.CALLER, 256),
        code=code.hex(), gas_limit=8_000_000, data=b"", gas_price=10, value=0,
        track_gas=True)
    assert len(laser.open_states) == 1, "laser run did not finish cleanly"
    account = laser.open_states[0][symbol_factory.BitVecVal(DIFF.ADDRESS, 256)]
    return {k.value: v.value for k, v in account.storage.printable_storage.items()}


@pytest.fixture(scope="module")
def programs():
    import random

    out = []
    for trial in range(DIFF.N_TRIALS):
        rng = random.Random(90210 + trial)
        gen = (DIFF.random_program, DIFF.random_memory_program,
               DIFF.random_branch_program)[trial % 3]
        out.append(gen(rng))
    return out


@pytest.fixture(scope="module")
def batch_storages(programs):
    table = make_code_table(programs, device="cpu")
    batch = make_batch(len(programs), code_ids=list(range(len(programs))),
                       caller=DIFF.CALLER, address=DIFF.ADDRESS, device="cpu")
    out, _ = run(batch, table, max_steps=512)
    assert all(int(s) != Status.RUNNING for s in out.status.tolist())
    return [storage_dict(out, lane) for lane in range(len(programs))]


@pytest.mark.parametrize("trial", range(DIFF.N_TRIALS))
def test_random_programs_agree(trial, programs, batch_storages):
    laser = {k: v for k, v in run_port_laser(programs[trial]).items() if v}
    batch = {k: v for k, v in batch_storages[trial].items() if v}
    assert laser == batch, programs[trial].hex()


# ---------------------------------------------------------------------------
# host takeover
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def takeover_lane():
    """(case, the port's final batch in the JAX package's numpy layout)
    for the lane the device halts UNSUPPORTED."""
    cases, _ = tconf.load_vmtests()
    (case,) = [c for c in cases if c.name == TAKEOVER_CASE]
    batch, table = tconf.build_batch([case], device="cpu")
    final, _ = run(batch, table, max_steps=4096, track_coverage=False)
    view = interop.batch_to_numpy(final)
    assert int(view.status[0]) == Status.UNSUPPORTED
    return case, view


def _state_view(state):
    """The lifted GlobalState's observable fields, as plain values."""
    ms = state.mstate
    env = state.environment
    account = env.active_account
    return {
        "pc": ms.pc,
        "stack": [w.value for w in ms.stack],
        "memory": [ms.memory[i] for i in range(len(ms.memory))],
        "gas": (ms.min_gas_used, ms.max_gas_used),
        "storage": {k.value: v.value for k, v in account.storage.printable_storage.items()},
        "balance": state.world_state.balances[account.address].value,
        "address": account.address.value,
        "caller": env.sender.value,
        "origin": env.origin.value,
        "callvalue": env.callvalue if isinstance(env.callvalue, int) else env.callvalue.value,
        "calldata": env.calldata.concrete(None),
        "code": env.code.bytecode,
    }


def test_lift_lane_equals_the_jax_package(takeover_lane):
    from mythril_tpu.laser.batch import takeover as jax_takeover

    case, view = takeover_lane
    _, port_state = port_takeover.lift_lane(case.code.hex(), view, 0)
    _, jax_state = jax_takeover.lift_lane(case.code.hex(), view, 0)
    got, want = _state_view(port_state), _state_view(jax_state)
    assert got == want
    assert got["pc"] > 0 and got["stack"]


def test_resume_on_host_equals_the_jax_package(takeover_lane):
    from mythril_tpu.laser.batch import takeover as jax_takeover

    case, view = takeover_lane
    got = port_takeover.resume_on_host(case.code.hex(), view, 0)
    want = jax_takeover.resume_on_host(case.code.hex(), view, 0)
    assert got is not None and got == want


def test_hybrid_replay_turns_the_skip_into_a_pass(takeover_lane):
    case, _ = takeover_lane
    assert tconf.run_cases([case], hybrid=False, device="cpu") == {
        TAKEOVER_CASE: "skip: opcode outside device set"}
    assert tconf.run_cases([case], device="cpu") == {TAKEOVER_CASE: "pass"}


def test_the_takeover_case_is_a_pinned_device_skip():
    pinned = json.loads((Path(tconf.__file__).with_name(
        "vmtests_device_verdicts.json")).read_text())["verdicts"]
    assert pinned[TAKEOVER_CASE] == "skip: opcode outside device set"


def test_chip_smoke_runs_the_same_programs(programs):
    """chip_smoke.py's copy of the generators (it imports nothing of the
    JAX package's suite) gives these programs."""
    import chip_smoke

    assert chip_smoke.diff_programs() == programs
    assert (chip_smoke.DIFF_CALLER, chip_smoke.DIFF_ADDRESS) == (DIFF.CALLER, DIFF.ADDRESS)
