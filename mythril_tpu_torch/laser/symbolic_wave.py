"""A seeded symbolic wave over the vendored contracts, and its digests.

The JAX explorer's first wave at its defaults (`DeviceCorpusExplorer`,
laser/batch/explore.py there): lanes in stripes of `lanes_per_stripe`,
stripe k running contract k % 13 of tests/testdata/vendored/inputs with
the calldata of `seeds.selector_seeds(code, lanes_per_stripe, 68,
random.Random(k))`, under the explorer's replay environment, caller and
address, with `mem_cap=16384`, `storage_cap=128` and the default
ARENA_CAP and EVENT_CAP.

The JAX package's per-field sha256 digests of one such wave after
`sym_run` are pinned in symbolic_wave_digests.json, so the card can be
held to them without JAX. Regenerate them with

    PYTHONPATH=. python tests/test_torch_arena.py --pin
"""

from __future__ import annotations

import hashlib
import json
import random
from pathlib import Path

import numpy as np

from mythril_tpu_torch.laser.batch import seeds
from mythril_tpu_torch.laser.batch.state import make_batch, make_code_table
from mythril_tpu_torch.laser.batch.symbolic import SymBatch, make_sym_batch

CONTRACTS = (Path(__file__).resolve().parents[2]
             / "tests" / "testdata" / "vendored" / "inputs")
PINNED = Path(__file__).with_name("symbolic_wave_digests.json")

# the explorer's defaults (explore.py DEFAULT_CALLER, DEFAULT_ADDRESS,
# REPLAY_ENV, DeviceCorpusExplorer's calldata_len/mem_cap/storage_cap)
DEFAULT_CALLER = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
DEFAULT_ADDRESS = 0x901D573B8CE8C997DE5F19173C32D966B4FA55FE
CALLDATA_LEN = 68
BATCH_KWARGS = dict(
    caller=DEFAULT_CALLER,
    address=DEFAULT_ADDRESS,
    timestamp=0x5BFA4639,
    number=0x66E393,
    gasprice=0x773594000,
    balance=0,
    mem_cap=16384,
    storage_cap=128,
)

#: the pinned wave: 13 stripes of 20 lanes, one per contract
PIN_SETTINGS = {"stripes": 13, "lanes_per_stripe": 20, "max_steps": 512,
                "calldata_len": CALLDATA_LEN, **BATCH_KWARGS}


def load_contracts() -> list:
    """The vendored runtime bytecodes, in file-name order."""
    return [bytes.fromhex(p.read_text().strip())
            for p in sorted(CONTRACTS.glob("*.sol.o"))]


def wave_inputs(codes, stripes: int, lanes_per_stripe: int, seed: int = 0):
    """(code_ids int32[N], calldata list, code_cap) of a striped wave;
    stripe k draws its random seeds from random.Random(seed + k)."""
    code_ids, calldata = [], []
    for k in range(stripes):
        c = k % len(codes)
        code_ids += [c] * lanes_per_stripe
        calldata += seeds.selector_seeds(codes[c].hex(), lanes_per_stripe,
                                         CALLDATA_LEN, random.Random(seed + k))
    cap = seeds.code_cap_bucket(max(len(c) for c in codes))
    return np.asarray(code_ids, np.int32), calldata, cap


def make_wave(stripes: int, lanes_per_stripe: int, device=None, seed: int = 0):
    """(SymBatch, CodeTable) of a fresh striped wave, on the card unless
    `device` names another."""
    codes = load_contracts()
    code_ids, calldata, cap = wave_inputs(codes, stripes, lanes_per_stripe, seed)
    table = make_code_table(codes, code_cap=cap, device=device)
    base = make_batch(len(code_ids), code_ids=code_ids, calldata=calldata,
                      device=device, **BATCH_KWARGS)
    return make_sym_batch(base), table


def _digest(arr) -> str:
    arr = np.ascontiguousarray(arr)
    head = f"{arr.dtype.str}{arr.shape}".encode()
    return hashlib.sha256(head + arr.tobytes()).hexdigest()


def field_digests(symb_np: SymBatch) -> dict:
    """{field: sha256} of a SymBatch of numpy arrays in the JAX dtypes
    (`interop.symbatch_to_numpy`, or `jax.device_get` of a JAX one); the
    base's fields are named `base.<field>`."""
    out = {f"base.{name}": _digest(arr)
           for name, arr in zip(symb_np.base._fields, symb_np.base)}
    out.update({name: _digest(arr)
                for name, arr in zip(SymBatch._fields[1:], symb_np[1:])})
    return out


def load_pinned() -> dict:
    """{"settings": ..., "steps": ..., "active_lane_steps": ...,
    "digests": {field: sha256}} as pinned from the JAX package."""
    return json.loads(PINNED.read_text())
