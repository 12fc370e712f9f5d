"""Test settings of the benchmark's own tests (run them with
`python -m pytest benchmark/tests`): the benchmark's packages and the
program on the import path, and the `cuda` marker of tests that need the
card, which decide inside the test whether there is one."""

import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
