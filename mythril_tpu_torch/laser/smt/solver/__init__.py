"""Solver layer of the port: `preprocess.lower` and the device
portfolio (`portfolio`). The JAX package's host CDCL stack (solver.py,
bitblast, native SAT, the race stage) is not ported yet."""
