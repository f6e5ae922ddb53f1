"""build_ms (ms, layer: api; moves setup_s): the median of the three timed
builds of the served engine in set-up, each
``NNEngine(version, device).build(refs)`` through
``torch.cuda.synchronize()``, after one untimed build."""

import statistics


def read(run):
    return statistics.median(run.build_ms) if run.build_ms else None
