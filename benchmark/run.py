"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up by name in
`BENCHMARK.json`; its traffic, configuration, scene builder, driver and
metrics are files under `benchmark/` (see benchmark/README.md). With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiler trace of the
window. The last line of standard output is the result as one JSON
object; the numbers compared by the correctness check close standard
error, each beside its limit.

Exits with 2, printing no result, without a CUDA card (or with fewer than
the cell asks for), and with 3 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def prepare_process() -> None:
    """Import paths, threads and cache directories: the benchmark's own
    packages and the program at the root of the checkout; one intra-op
    thread for PyTorch's and NumPy's host work (the host's cores are
    shared, and spinning worker threads made host-bound frames slower and
    less steady); any PyTorch extension or Triton cache at a fixed path
    inside the checkout. The program builds its kernel libraries into its
    own `_build/` there. Call before importing torch."""
    for p in (str(BENCH_DIR), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = BENCH_DIR / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    prepare_process()
    from harness import cell, discover, guard

    bench = discover.load_benchmark(ROOT)
    chips = int(discover.cell(bench, args.workload)["entry"]["chips"])
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count() = "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cell.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), T0)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
