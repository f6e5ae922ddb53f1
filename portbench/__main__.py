"""``python -m portbench``: one run of one cell (see ``portbench.run``)."""

import time

T0 = time.perf_counter()  # set-up is timed from here, before torch is imported

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
