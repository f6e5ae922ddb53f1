"""The benchmark of ``nns_tpu_torch``, the PyTorch and CUDA port.

Run one cell from the repository root::

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, metrics and bounds. Each
cell's configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), point distribution (``distributions/<name>.py``),
call shape (``calls/<name>.py``, named by the mix), answer check
(``answers/<name>.py``, named by the mix) and metric reader
(``metrics/<name>.py``) sit in files of their own, found by name, so that
a new cell, mix, entry point or metric needs only new files and entries.
Nothing here imports ``jax`` or the JAX package; the port is reached only
through ``nns_tpu_torch.api.NNEngine`` (and ``nns_tpu_torch.kernels._cuda``
to build its kernel library in set-up).
"""
