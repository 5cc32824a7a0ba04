"""Seconds from process start to the first timed solve: imports, the CUDA
context, the problem, SparseLM's construction, loading (and, in a fresh
checkout, building) the CUDA libraries, and the warm-up solve."""


def read(run):
    return run.setup_s
