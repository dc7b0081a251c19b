"""Train a ~1M-param LM (tinyllama smoke config) for a few hundred steps
on the port (the driver of the JAX package's ``examples/train_lm.py``,
the same command): AdamW + cosine schedule, async checkpointing, and a
simulated mid-run preemption that the resilient driver recovers from
bit-exactly.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

It runs ``python -m repro_torch.launch.train`` as a subprocess, on the
CUDA card unless ``--device cpu`` asks for the CPU; with no card and no
``--device`` it raises ``RuntimeError`` before it starts one.  The
checkpoints go to a temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as td:
        cmd = [
            sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "tinyllama-1.1b", "--steps", "200",
            "--batch", "8", "--seq-len", "128",
            "--ckpt-dir", td, "--ckpt-every", "40",
            "--preempt-at", "90", "--device", dev.type,
        ]
        print("+", " ".join(cmd))
        subprocess.run(cmd, check=True, env=env)


if __name__ == "__main__":
    main()
