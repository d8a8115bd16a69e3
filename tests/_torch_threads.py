"""Pins torch to one intra-op thread in the port's test processes.

Every ``tests/test_torch_*.py`` imports this module before anything
else.  The suite runs in several pytest-xdist workers on one host;
with torch's default of one intra-op thread per core, each worker's
thread pool competes with every other worker's for the same cores, and
a test that takes seconds alone takes minutes beside five copies of
itself.  One thread per worker keeps the workers from oversubscribing
the host.
"""
import torch

torch.set_num_threads(1)
