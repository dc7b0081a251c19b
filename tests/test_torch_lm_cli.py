"""The port's LM training CLI on the CPU at tinyllama's smoke config,
with the JAX package's ``examples/train_lm.py`` command (200 steps,
batch 8, seq 128, checkpoints every 40, preempted at 90): the run
restarts once and ends bit-equal to a clean run of the same 200 steps,
losses and final checkpoint alike.  The two runs are subprocesses,
started together.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = ["--arch", "tinyllama-1.1b", "--steps", "200", "--batch", "8",
       "--seq-len", "128", "--ckpt-every", "40", "--device", "cpu"]


def _start(ckpt_dir, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CMD,
         "--ckpt-dir", str(ckpt_dir), *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="2"))


def _finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    return out.splitlines()


def _final_leaves(ckpt_dir):
    d = os.path.join(ckpt_dir, "step_00000200")
    with open(os.path.join(d, "manifest.json")) as f:
        recs = json.load(f)["leaves"]
    return {r["name"]: np.load(os.path.join(d, r["file"])) for r in recs}


def test_preempted_lm_run_ends_bit_equal_to_a_clean_run(tmp_path):
    runs = {"preempted": _start(tmp_path / "p", "--preempt-at", "90"),
            "clean": _start(tmp_path / "c")}
    lines = {k: _finish(p) for k, p in runs.items()}
    # stragglers count slow steps on the host clock: load, not the result
    assert lines["preempted"][0].startswith("arch=tinyllama-1.1b steps=200 "
                                            "restarts=1 stragglers=")
    assert lines["clean"][0].startswith("arch=tinyllama-1.1b steps=200 "
                                        "restarts=0")
    ckpts = [ln.split()[1] for ln in lines["preempted"]
             if ln.startswith("ckpt:")]
    assert {"step=40", "step=80", "step=90", "step=200"} <= set(ckpts)
    rep = {k: json.loads(v[-1][len("report: "):]) for k, v in lines.items()}
    assert len(rep["clean"]["losses"]) == 200
    assert rep["preempted"]["losses"] == rep["clean"]["losses"]
    assert rep["clean"]["losses"][-1] < rep["clean"]["losses"][0] - 1.0
    assert rep["clean"]["tokens_per_step"] == 8 * 128
    want, got = _final_leaves(tmp_path / "c"), _final_leaves(tmp_path / "p")
    assert set(got) == set(want) and len(want) > 20
    for name, w in want.items():
        assert got[name].tobytes() == w.tobytes(), name
