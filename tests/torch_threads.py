"""Caps torch at two intra-op threads when imported.

The port's CPU test files import this module. pytest-xdist runs several
workers on the CPU at once, and each worker's torch would otherwise start
as many intra-op threads as there are cores: the workers then
oversubscribe the CPU and run several times slower. A worker collects
every test file, so any one import caps it; each file imports the module
so that it is capped when run on its own too."""

import torch

torch.set_num_threads(2)
