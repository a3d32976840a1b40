"""One generation of the flip frontier, end to end on the CPU.

A contract whose only branch tests the first calldata byte
(`calldataload(0) >> 248 == 0x42`) runs as a 4-lane symbolic wave on
zero calldata. The frontier must hold one candidate (every lane takes
the same direction; the target is attempted once), its query must be
solved by the portfolio's SLS (a lane polarity-seeded with the pool's
0x42 solves it at once), the witness must become the lane's next
calldata with byte 0 = 0x42 while the other lanes draw fresh
`selector_seeds`, and the next wave must take the flipped direction:
the flip is realized and the lane's SSTORE ran. The decode's parity with
the JAX package is held on the pinned wave in test_torch_arena.py.
"""

import random

import numpy as np
import pytest
import torch

from mythril_tpu_torch.laser import flip_frontier as ff
from mythril_tpu_torch.laser import symbolic_wave as wave
from mythril_tpu_torch.laser.batch import seeds
from mythril_tpu_torch.laser.batch.arena import ArenaView
from mythril_tpu_torch.laser.batch.state import make_batch, make_code_table, storage_dict
from mythril_tpu_torch.laser.batch.symbolic import make_sym_batch, sym_run

torch.set_num_threads(1)

# 0: PUSH1 0; CALLDATALOAD; PUSH1 0xf8; SHR; PUSH1 0x42; EQ; PUSH1 13;
# 11: JUMPI; 12: STOP; 13: JUMPDEST; PUSH1 1; PUSH1 0; SSTORE; STOP
CODE = bytes.fromhex("600035" "60f8" "1c" "6042" "14" "600d" "57" "00" "5b" "6001" "6000" "55" "00")
JUMPI_PC = 11
LANES, PER_STRIPE = 4, 2


@pytest.fixture(scope="module")
def generation():
    code_ids = np.zeros(LANES, np.int32)
    base = make_batch(LANES, code_ids=code_ids, calldata=[bytes(wave.CALLDATA_LEN)] * LANES,
                      device="cpu", **wave.BATCH_KWARGS)
    table = make_code_table([CODE], device="cpu")
    out, _, _ = sym_run(make_sym_batch(base), table, max_steps=64)
    by_contract = ff.lanes_by_contract(code_ids)
    res = ff.solve_frontier(ArenaView(out), {}, by_contract, device="cpu", steps=8,
                            cube_depth=0)
    calldata = ff.generation_calldata([CODE], code_ids, PER_STRIPE, 1, res["witnesses"])
    out2, _ = ff.next_wave(out, table, code_ids, calldata, max_steps=64)
    return res, calldata, out2, by_contract


def test_frontier_holds_one_candidate_and_solves_it(generation):
    res = generation[0]
    assert res["decisions"] == {"symbolic": LANES, "opaque": 0, "concrete": 0}
    assert (res["tried"], res["opaque"], len(res["candidates"])) == (1, 0, 1)
    lane, k, _conds, target = res["candidates"][0]
    assert (lane, k, target) == (0, 0, (JUMPI_PC, True))
    (verdict,) = res["verdicts"]
    assert (verdict.status, verdict.via, res["witness_invalid"]) == ("sat", "sls", 0)
    assert verdict.assignment["cd0"] == 0x42
    assert res["verdicts_by_via"] == {"sls": 1} and res["compile_losses"] == {}


def test_witness_seeds_its_lane_and_the_others_redraw(generation):
    res, calldata, _, _ = generation
    assert calldata[0] == res["witnesses"][0] and calldata[0][0] == 0x42
    want = []
    for k in range(LANES // PER_STRIPE):
        want += seeds.selector_seeds(CODE.hex(), PER_STRIPE, wave.CALLDATA_LEN,
                                     random.Random(1 * (LANES // PER_STRIPE) + k))
    assert calldata[1:] == want[1:]


def test_next_wave_realizes_the_flip(generation):
    _, calldata, out2, by_contract = generation
    view = ArenaView(out2)
    assert ff.realized(view, by_contract, {0: [(JUMPI_PC, True)]}) == 1
    assert view.journal(0)[0][:2] == (JUMPI_PC, True)
    assert storage_dict(out2.base, 0) == {0: 1}
    assert [storage_dict(out2.base, lane) for lane in (1, 2, 3)] == [
        {0: 1} if data[0] == 0x42 else {} for data in calldata[1:]]


def test_witness_bytes_read_calldata_variables_only():
    data = ff.witness_bytes({"cd0": 0x1FF, "cd67": 7, "cd68": 9, "dev_exp_1": 5, "cdx": 3})
    assert len(data) == wave.CALLDATA_LEN and data[0] == 0xFF and data[67] == 7
    assert sum(data) == 0xFF + 7
