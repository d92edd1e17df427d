"""Fault injection / elastic recovery (SURVEY.md §5 'failure detection'):
a production run SIGKILLed mid-flight must resume from its last atomic
checkpoint and land on the same final state as an uninterrupted run.

The reference has no recovery story at all (a failed solve just throws);
this is the package's crash-consistency contract: checkpoints are atomic
(tmp + rename / orbax commit), resume re-enters the compiled loop at the
saved (Y, t), and the trajectory is reproducible across the restart."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "experiments", "soil", "production_run.py")

ARGS = [
    "--platform", "cpu", "--ncol", "96", "--nz", "10",
    "--hours", "0.02", "--dt", "5.0", "--segment-minutes", "0.2",
]


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(workdir, resume=False, timeout=600):
    cmd = [sys.executable, DRIVER, *ARGS, "--workdir", workdir]
    if resume:
        cmd.append("--resume")
    return subprocess.run(
        cmd, env=_env(), capture_output=True, text=True, timeout=timeout,
    )


def _final_state(workdir):
    from landhydrology.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    # template shapes must match the driver's model
    import jax.numpy as jnp

    Y_tmpl = {
        "soil": {
            "vartheta_l": jnp.zeros((10, 96), jnp.float32),
            "theta_i": jnp.zeros((10, 96), jnp.float32),
            "rho_e_int": jnp.zeros((10, 96), jnp.float32),
        }
    }
    Y, t, step = mgr.restore(Y_tmpl)
    return Y, t, step


@pytest.mark.slow
def test_sigkill_then_resume_matches_uninterrupted(tmp_path):
    clean = str(tmp_path / "clean")
    faulty = str(tmp_path / "faulty")

    # 1. uninterrupted reference run
    r = _run(clean)
    assert r.returncode == 0, r.stderr[-2000:]
    Y_ref, t_ref, step_ref = _final_state(clean)

    # 2. start the same run, SIGKILL it once the first checkpoint lands
    proc = subprocess.Popen(
        [sys.executable, DRIVER, *ARGS, "--workdir", faulty],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    ckpt_dir = os.path.join(faulty, "ckpt")
    deadline = time.time() + 540
    killed = False
    while time.time() < deadline:
        if proc.poll() is not None:
            break  # finished before we could kill it — still a valid test
        n = len(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else 0
        if n >= 1:
            time.sleep(0.3)  # land mid-segment, after an atomic commit
            proc.send_signal(signal.SIGKILL)
            killed = True
            break
        time.sleep(0.2)
    proc.wait(timeout=60)
    if killed:
        assert proc.returncode != 0  # it really died

    # 3. resume and finish
    r2 = _run(faulty, resume=True)
    assert r2.returncode == 0, r2.stderr[-2000:]
    if killed:
        assert "resumed from step" in r2.stdout

    # 4. the recovered trajectory ends at the identical state
    Y_f, t_f, step_f = _final_state(faulty)
    assert step_f == step_ref and t_f == pytest.approx(t_ref)
    for k in Y_ref["soil"]:
        np.testing.assert_allclose(
            np.asarray(Y_f["soil"][k]), np.asarray(Y_ref["soil"][k]),
            rtol=1e-7, atol=0.0, err_msg=k,
        )
