"""LM steps a solve, every phase, over all of the window's solves
(``len(SparseLM.history)`` summed over the phases)."""


def read(run):
    steps = sum(len(p) for s in run.solves for p in s.hist)
    return steps / len(run.solves)
