"""The port's corpus synthesis against the JAX package's.

`mythril_tpu_torch.analysis.corpusgen` is host-only (no tensors): for the
same arguments every generator must return the JAX package's bytes, and
`synth_bench_corpus` the same rows in the same order, the verdict-store
(dupes, forks), proxy, minimal-proxy and cross-call populations included.
One parametrised test, a case per generator and seed. The fixture
directory is the same resolution (`goldens.GOLDEN_FIXTURES`) in both.
"""

import random

import pytest

from mythril_tpu.analysis import corpusgen as jax_gen
from mythril_tpu.analysis import goldens as jax_goldens
from mythril_tpu_torch.analysis import corpusgen as port_gen
from mythril_tpu_torch.analysis import goldens as port_goldens

SEEDS = (0, 1, 7)


def _mutants(gen):
    """mutate_constants over every fixture, three seeds each, with the
    skeleton check the JAX suite makes."""
    out = []
    for name, code_hex in gen.load_fixtures():
        for seed in SEEDS:
            code = bytes.fromhex(code_hex)
            mutant = gen.mutate_constants(code, random.Random(f"{seed}:{name}"))
            out.append((name, mutant.hex(), gen._check_skeleton(code, mutant)))
    return out


#: case -> a function of the corpusgen module giving what is compared
CASES = {
    "fixture_dir": lambda g: str(g.fixture_dir()),
    "load_fixtures": lambda g: g.load_fixtures(),
    "mutate_constants": _mutants,
    "synth_corpus": lambda g: [g.synth_corpus(40, seed=s) for s in (2024,) + SEEDS],
    "loop_contract": lambda g: [g.loop_contract(c) for c in (0x1F, 0x3F, 0x7F, 0xFF)],
    "degrader_contract": lambda g: [g.degrader_contract(a) for a in (0x2000, 0x2400, 0x5000)],
    "wide_contract": lambda g: [g.wide_contract(n, seed=s) for n in (6, 7, 8) for s in SEEDS],
    "bec_contract": lambda g: [g.bec_contract(s) for s in SEEDS],
    "deadweight_contract": lambda g: [g.deadweight_contract(s) for s in SEEDS],
    "clean_contract": lambda g: [g.clean_contract(s) for s in SEEDS],
    "fork_contract": lambda g: [g.fork_contract(s, v) for s in SEEDS for v in (0, 1)],
    "proxy_pair": lambda g: [g.proxy_pair(s, v, c) for s in SEEDS for v in (0, 1)
                             for c in (False, True)],
    "minimal_proxy": lambda g: [g.minimal_proxy(s) for s in SEEDS],
    "cross_call_pair": lambda g: [g.cross_call_pair(s) for s in SEEDS],
    "linked_leaf": lambda g: [g._linked_leaf(0xD00DFEED + s, 0x21 + s, 2, 0xB1 + s)
                              for s in SEEDS],
    "poison_contract": lambda g: [g.poison_contract(s) for s in SEEDS],
    "synth_bench_corpus_default": lambda g: g.synth_bench_corpus(32),
    "synth_bench_corpus_seeds": lambda g: [g.synth_bench_corpus(40, seed=s) for s in SEEDS],
    "synth_bench_corpus_populations": lambda g: [
        g.synth_bench_corpus(32, dupes=2, forks=2, proxy_pairs=1, minimal_proxies=1,
                             cross_call_pairs=1),
        g.synth_bench_corpus(48, seed=3, dupes=3, forks=4, proxy_pairs=2,
                             minimal_proxies=2, cross_call_pairs=2),
    ],
    "golden_fixtures": lambda g: None,
}


@pytest.mark.parametrize("case", list(CASES))
def test_corpusgen_equals_the_jax_package(case):
    if case == "golden_fixtures":
        assert port_goldens.GOLDEN_FIXTURES == jax_goldens.GOLDEN_FIXTURES
        assert port_goldens.GOLDEN_EXECUTION_TIMEOUT == jax_goldens.GOLDEN_EXECUTION_TIMEOUT
        return
    got, want = CASES[case](port_gen), CASES[case](jax_gen)
    assert got == want
    assert got  # every case compares something
    if case == "mutate_constants":
        assert all(ok for _, _, ok in got)
    if case == "synth_bench_corpus_populations":
        names = [name for _, _, name in got[0]]
        assert len(got[0]) == 32 and any("dupe" in n for n in names)
        assert any(n.startswith("fork#") for n in names)
        assert any(n.startswith("impl#") for n in names)
        assert any(n.startswith("minproxy#") for n in names)


def test_clean_contract_is_the_chip_scripts_clean_row():
    """chip_smoke.py takes its statically answered contract from the
    port's clean_contract(0); the bytes are those the script held as a
    literal before."""
    assert port_gen.clean_contract(0) == (
        "600035" "60e01c" "80" "63c0ffee00" "14" "601a" "57" "630ddba110" "14"
        "6024" "57" "00" "5b" "6001" "6002" "01" "6000" "55" "00"
        "5b" "602a" "6000" "52" "6020" "6000" "f3")
