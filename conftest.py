"""One intra-op thread per test process.

The port's CPU tests step small tensors in Python loops (scans, decode
steps, training steps at smoke size), and the suite runs several
processes at once (pytest-xdist workers, and the subprocesses that the
dry-run and ``gloo`` mesh tests start). With torch's default pool of
one thread per core in every process, each small op wakes a pool that
the other processes are using too, and runs slower, not faster. Under
six workers on eight cores, ``tests/test_torch_chunked_scans.py`` took
1099 s on its worker with the default pool and 30 s with one thread;
the whole suite 1130 s and 272 s.

pytest imports this file first, in the controlling process, before any
test module imports torch, so every worker and every subprocess a test
starts inherits the setting. ``setdefault`` keeps a value that is set
explicitly in the environment. The benchmark (``portbench/run.py``)
pins its own threads and does not read this file.
"""
import os

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
