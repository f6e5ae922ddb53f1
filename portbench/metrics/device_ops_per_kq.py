"""device_ops_per_kq (ops/kquery, layer: engine): device operations
(kernels, copies and sets) in the traced window per 1000 queries answered
there: the glue that a fusion or a captured graph would remove."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not run.queries:
        return None
    return len(t.ops) / (run.queries / 1000.0)
