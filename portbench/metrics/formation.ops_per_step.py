"""Device operations an LM step outside the benchmark's span around the
program's call into ops/stencil_cg.py, in the traced stretch: residuals,
Jacobians, the normal equations' pieces, the preconditioner's inverse,
the candidate's chi2 and the LM bookkeeping, until spans inside the
program split them."""


def read(run):
    st = run.stretch
    if st is None:
        return None
    steps = sum(len(p) for s in st['solves'] for p in s.hist)
    return (st['device_ops'] - st['span_ops']) / steps
