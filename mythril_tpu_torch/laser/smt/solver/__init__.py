"""Solver layer of the port: `preprocess.lower`, the device portfolio
(`portfolio`), query capture (`capture`) and the chip-occupancy flag
(`device_race.DEVICE_BUSY`). The JAX package's host CDCL stack
(solver.py, bitblast, native SAT, the race stage) is not ported yet."""
