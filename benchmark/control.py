"""Readings that the check's limit is set from, on the card: for each seed,
one short run of the cell (the program's reading of `off_px_share` on the
window's own frames) and, on the same frames and pixels, the plain
reference computed in the nearest precision below the configuration's
(float32 -> bfloat16) put in the program's place (the control's reading).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

One set-up of the libraries serves every seed (one process). Prints a
line a seed and, last, one JSON object with the readings. The benchmark's
own runs (`run.py`) never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.prepare_process()
    import torch

    torch.set_num_threads(1)
    from harness import cell, discover

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = discover.load_benchmark(run.ROOT)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = cell.run_cell(bench, args.workload, seed, args.seconds, False,
                          time.perf_counter(), control_dtype=torch.bfloat16)
        row = {"seed": seed, "program": r["checks"]["off_px_share"]["value"],
               "control": r["control"]["off_px_share"], "correct": r["correct"],
               "failed": r["failed"], "frames": r["attempted"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(),
                      "readings": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
