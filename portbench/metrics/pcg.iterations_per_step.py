"""CG iterations an LM step (``SparseLM.cg_iterations``, damping retries
included), over all of the window's solves."""


def read(run):
    its = sum(i for s in run.solves for p in s.its for step in p
              for i in step)
    steps = sum(len(p) for s in run.solves for p in s.hist)
    return its / steps
