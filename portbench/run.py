"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload rho-open --seed 7 --seconds 30 --trace 0

Run from the root of a checkout that holds ``src/repro_torch``.  It
needs as many CUDA cards as the cell asks for and exits non-zero with
no result line without them.  The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the
check compared, each beside its limit.  ``--sweep`` (not used by the
check) runs the cell's set-up once and then one window at each listed
open-loop rate, printing one line a rate.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the kernels' build caches live at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default="",
                    help="comma-separated open-loop rates (q/s)")
    args = ap.parse_args(argv)

    import torch
    from portbench import bench

    spec = bench.load_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        bench.log(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"available: {torch.cuda.is_available()}, "
                  f"count {torch.cuda.device_count()}")
        return 2
    import repro_torch  # noqa: F401 -- the system under test must exist
    device = torch.device("cuda", 0)
    if args.sweep:
        from portbench import sweep
        sweep.run(spec, args.seed, args.seconds,
                  [float(r) for r in args.sweep.split(",")], device, T_BEGIN)
        return 0
    out, checks = bench.run(spec, args.seed, args.seconds, bool(args.trace),
                            device, T_BEGIN)
    bad = bench.forbidden_modules()
    if bad:
        bench.log(f"portbench: forbidden modules loaded: {bad}")
        return 3
    for name, value, limit in checks:
        bench.log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
