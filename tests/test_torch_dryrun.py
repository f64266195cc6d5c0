"""The port's multi-rank dry run (surreal_tpu_torch/dryrun.py, the
counterpart of __graft_entry__.dryrun_multichip) on the CPU: 2 gloo
ranks, each a process of its own, run the reference's six layouts (dp,
dp + zero, dp + lstm, dp x time, dp x model, dp (ddpg)) through the
trainers the CLI builds; rank 0 prints each one's finite metrics."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_runs_the_six_layouts():
    done = subprocess.run([sys.executable, "-m", "surreal_tpu_torch.dryrun", "2", "cpu"],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=150)
    assert done.returncode == 0, done.stderr[-3000:]
    ok = [line for line in done.stdout.splitlines() if line.startswith("dryrun_multichip(2)")]
    assert [line.split(" OK:")[0] for line in ok] == [
        f"dryrun_multichip(2) {label}" for label in
        ("dp", "dp + zero", "dp + lstm", "dp x sp(time)", "dp x tp(model)", "dp (ddpg)")]
