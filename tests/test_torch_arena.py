"""The pinned symbolic wave, and the port's ArenaView against the JAX one.

The wave is the JAX explorer's first wave at its defaults over the 13
vendored contracts (`mythril_tpu_torch/laser/symbolic_wave.py`: 13
stripes of 20 lanes, `selector_seeds` calldata, mem_cap 16384,
storage_cap 128, ARENA_CAP and EVENT_CAP as in symbolic.py), run for up
to 512 steps by the JAX `sym_run` and by the port's on the CPU. Every
SymBatch field of both must hash to the digests pinned in
`mythril_tpu_torch/laser/symbolic_wave_digests.json` (exact equality:
sha256 of the JAX-dtype bytes), which chip_smoke.py holds the card to.
The port's `ArenaView` of its wave must equal the JAX `ArenaView` of the
JAX wave: every array, the byte counts, and per lane the events, branch
journal, used roots, wrap usage and DAG source ops.

Regenerate the pinned digests from the JAX package with

    PYTHONPATH=. python tests/test_torch_arena.py --pin
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser.batch.arena import ArenaView as JaxArenaView
from mythril_tpu.laser.batch.state import StateBatch as JaxBatch
from mythril_tpu.laser.batch.state import make_batch as jax_make_batch
from mythril_tpu.laser.batch.state import make_code_table as jax_make_code_table
from mythril_tpu.laser.batch.symbolic import SymBatch as JaxSym
from mythril_tpu.laser.batch.symbolic import make_sym_batch as jax_make_sym_batch
from mythril_tpu.laser.batch.symbolic import sym_run as jax_sym_run
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import symbolic_wave as wave
from mythril_tpu_torch.laser.batch.arena import ArenaView
from mythril_tpu_torch.laser.batch.symbolic import sym_run
from mythril_tpu_torch.support import hostsync

torch.set_num_threads(1)

SETTINGS = wave.PIN_SETTINGS
FIELDS = [f"base.{name}" for name in JaxBatch._fields] + list(JaxSym._fields[1:])
VIEW_ARRAYS = [
    "op", "a", "b", "va", "vb", "br_pc", "br_taken", "br_tid", "br_cnt",
    "calldatasize", "ev_pc", "ev_kind", "ev_tid", "ev_vtid", "ev_a", "ev_b",
    "ev_aux", "ev_gas", "ev_cnt", "ev_overflow", "ret_off", "ret_len",
    "sval_tid", "mem_tid_head", "status", "halt_pc", "gas_min", "gas_max",
    "storage_keys", "storage_vals", "storage_cnt",
]


def jax_wave():
    """(final SymBatch of jax arrays, steps, active lane steps)."""
    codes = wave.load_contracts()
    code_ids, calldata, cap = wave.wave_inputs(codes, SETTINGS["stripes"],
                                               SETTINGS["lanes_per_stripe"])
    base = jax_make_batch(len(code_ids), code_ids=code_ids, calldata=calldata,
                          **wave.BATCH_KWARGS)
    out, steps, active = jax_sym_run(jax_make_sym_batch(base),
                                     jax_make_code_table(codes, code_cap=cap),
                                     max_steps=SETTINGS["max_steps"])
    return out, int(steps), int(active)


@pytest.fixture(scope="module")
def jax_run():
    return jax_wave()


@pytest.fixture(scope="module")
def port_run():
    symb, table = wave.make_wave(SETTINGS["stripes"], SETTINGS["lanes_per_stripe"],
                                 device="cpu")
    out, steps, active = sym_run(symb, table, max_steps=SETTINGS["max_steps"])
    return out, steps, int(active)


@pytest.fixture(scope="module")
def pinned():
    return wave.load_pinned()


def test_pinned_file_holds_this_wave(pinned):
    assert pinned["settings"] == SETTINGS
    assert sorted(pinned["digests"]) == sorted(FIELDS)
    assert 0 < pinned["steps"] < SETTINGS["max_steps"]


def test_jax_wave_regenerates_the_pinned_digests(jax_run, pinned):
    out, steps, active = jax_run
    assert (steps, active) == (pinned["steps"], pinned["active_lane_steps"])
    assert wave.field_digests(jax.device_get(out)) == pinned["digests"]


@pytest.mark.parametrize("field", FIELDS)
def test_port_wave_field_matches_pinned_digest(field, port_run, pinned):
    out, steps, active = port_run
    assert (steps, active) == (pinned["steps"], pinned["active_lane_steps"])
    assert wave.field_digests(interop.symbatch_to_numpy(out))[field] == pinned["digests"][field]


@pytest.fixture(scope="module")
def views(jax_run, port_run):
    hostsync.COUNT = 0
    port_view = ArenaView(port_run[0])
    reads = hostsync.COUNT
    return port_view, JaxArenaView(jax.tree_util.tree_map(jnp.asarray, jax_run[0])), reads


def test_view_costs_two_host_reads(views):
    assert views[2] == 2


@pytest.mark.parametrize("name", VIEW_ARRAYS)
def test_view_array_matches_jax(name, views):
    port, ref, _ = views
    got, want = getattr(port, name), getattr(ref, name)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_view_counts_match_jax(views):
    port, ref, _ = views
    assert (port.count, port.bytes_fetched, port.bytes_full) == (
        ref.count, ref.bytes_fetched, ref.bytes_full)
    assert 0 < port.bytes_fetched < port.bytes_full
    for got, want in zip(port.storage_tables(), ref.storage_tables()):
        np.testing.assert_array_equal(got, want)


def test_view_methods_match_jax_on_every_lane(views):
    port, ref, _ = views
    n_events = n_roots = 0
    for lane in range(port.status.shape[0]):
        assert port.events(lane) == ref.events(lane)
        assert port.journal(lane) == ref.journal(lane)
        roots = port.used_roots(lane)
        assert roots == ref.used_roots(lane)
        tids = set(roots) | {tid for _, _, tid in port.journal(lane)}
        tids |= {ev["tid"] for ev in port.events(lane)}
        for tid in sorted(tids):
            assert port.dag_source_ops(tid) == ref.dag_source_ops(tid), (lane, tid)
            assert port.subterms(tid) == ref.subterms(tid), (lane, tid)
        for ev in port.events(lane):
            assert port.wrap_used(lane, ev["tid"]) == ref.wrap_used(lane, ev["tid"])
        n_events += len(port.events(lane))
        n_roots += len(roots)
    assert n_events > 0 and n_roots > 0


def _pin():
    out, steps, active = jax_wave()
    out = jax.device_get(out)
    wave.PINNED.write_text(json.dumps({
        "settings": SETTINGS,
        "steps": steps,
        "active_lane_steps": active,
        "ar_count": int(out.ar_count),
        "digests": wave.field_digests(out),
    }, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(FIELDS)} field digests of a {steps}-step wave to {wave.PINNED}")


if __name__ == "__main__" and "--pin" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _pin()
