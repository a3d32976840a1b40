"""mythril_tpu_torch: the batched EVM interpreter ported to PyTorch and
CUDA for an NVIDIA H100.

A package beside the JAX one, imported without it: it imports torch and
never jax. Entry points build their tensors on the card unless the
caller passes `device="cpu"`:

- `laser.batch.make_batch` / `make_code_table` / `run`;
- `laser.batch.symbolic.sym_run` / `reseed_wave` over
  `laser.symbolic_wave.make_wave`, read back by `laser.batch.arena.ArenaView`;
- `laser.conformance.run_cases` (VMTests replay);
- `laser.flip_frontier.solve_frontier` / `next_wave` /
  `run_generations` (a wave's flip frontier decoded, lowered and solved
  by `laser.smt.solver.portfolio.device_solve_batch`, its witnesses
  seeding the next wave);
- `ops.keccak.keccak256`.

The hand-written kernels, built with nvcc at first use, are keccak-f[1600]
and the SHA3 sponge of the step (csrc/keccak_f.cu, bound in
ops/keccak_cuda.py), the per-lane slot write of one table or of up
to 8 tables that share an index (csrc/slot_write.cu, bound in
ops/slot_write.py), and the portfolio solver's program evaluation and
local search (csrc/portfolio.cu and csrc/portfolio_sls.cu over
csrc/portfolio.cuh, bound in ops/portfolio_eval.py and
ops/portfolio_sls.py).
"""

__version__ = "0.1.0"
