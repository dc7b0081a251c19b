"""The readings that the check's limits are set from, at a cell's own
size: for each seed a short window of the cell's traffic, then the
three numbers of the program and of the control (the reference computed
in bfloat16 in the program's place) on the same sample, and the verdict
that the cell's limits give each.

    python3 portbench/control.py --workload rho-open --seeds 11,12,13 --seconds 3

One JSON line a seed.  Not part of a benchmark run.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    from portbench import bench, check
    if not torch.cuda.is_available():
        bench.log("portbench control: no CUDA card")
        return 2
    spec = bench.load_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out, _ = bench.run(spec, seed, args.seconds, False,
                           torch.device("cuda", 0), time.perf_counter(),
                           control=True)
        print(json.dumps(dict(
            seed=seed, correct=out["correct"],
            program={k: v["value"] for k, v in out["checks"].items()},
            control=out["control"],
            control_correct=check.verdict(out["control"],
                                          spec["config"]["limits"]))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
