"""The plain reference of the benchmark's cells, in plain PyTorch: SFC
keys, the cornerstone octree and fixed-radius neighbour counts, written
from the reference library's definitions. It imports nothing of the
program and takes nothing the program made: the harness hands it the
positions it made from the seed."""
