"""``python -m tputopo_torch train`` with the parallelism flags, as gangs of
2 processes over gloo on the CPU (the gang's env, as
tests/test_torch_cli.py's gang): ``--experts --ep`` and ``--pp``, each
with a checkpoint resumed onto another plan, ``--sp`` with either
``--sp-impl``, and ``--lora-rank`` with ``--pp``.  Each prints the reference's keys with
one loss agreed by both ranks, and the loss falls."""

import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from tputopo_torch import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_KEYS = {"devices", "mesh", "steps", "resumed_from", "final_step", "preempted",
              "first_loss", "last_loss"}
SMALL = ["--device", "cpu", "--seq", "32", "--batch", "4"]


def _gang(*args) -> list[dict]:
    """Run ``train *args`` in 2 processes -> each rank's JSON line."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPUTOPO_NUM_PROCESSES", "TPUTOPO_PROCESS_ID", "TPUTOPO_GANG_SIZE")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tputopo_torch", "train", *SMALL, *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, OMP_NUM_THREADS="1", TPUTOPO_NUM_PROCESSES="2",
                 TPUTOPO_COORDINATOR=f"localhost:{port}", JOB_COMPLETION_INDEX=str(rank)))
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads([ln for ln in out.splitlines() if ln.strip()][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert outs[0] == outs[1]  # one global loss, agreed by both ranks
    assert set(outs[0]) == TRAIN_KEYS and outs[0]["devices"] == 2
    return outs


@pytest.mark.parametrize("flags,axis", [
    (["--pp", "2"], "pp"),
    (["--sp", "2", "--tp", "1"], "sp"),
    (["--sp", "2", "--tp", "1", "--sp-impl", "a2a"], "sp"),
    (["--lora-rank", "4", "--pp", "2"], "pp"),
])
def test_parallel_flags_train_as_a_gang(flags, axis):
    out = _gang(*flags, "--steps", "3")[0]
    assert out["mesh"][axis] == 2 and out["mesh"]["tp"] == 1
    assert out["final_step"] == 3 and out["last_loss"] < out["first_loss"]


def test_experts_over_ep_checkpoint_resumes_onto_another_plan(tmp_path):
    """Saved at {ep: 2}, restored at the default plan of 2 devices (tp 2):
    the expert tables reshard from the expert axis to d_ff."""
    ckpt = str(tmp_path / "moe")
    first = _gang("--experts", "4", "--ep", "2", "--steps", "3", "--ckpt-dir", ckpt)[0]
    assert first["mesh"]["ep"] == 2 and first["last_loss"] < first["first_loss"]
    second = _gang("--experts", "4", "--steps", "2", "--ckpt-dir", ckpt)[0]
    assert second["mesh"]["tp"] == 2 and second["mesh"]["ep"] == 1
    assert second["resumed_from"] == 3 and second["final_step"] == 5
    assert ck.latest_step(ckpt) == 5


def test_pipeline_checkpoint_resumes_onto_another_plan(tmp_path):
    """Saved at {pp: 2} (each rank its stage's layers), restored at the
    default plan of 2 devices (tp 2): the layer axis reshards."""
    ckpt = str(tmp_path / "pp")
    first = _gang("--pp", "2", "--steps", "2", "--ckpt-dir", ckpt)[0]
    assert first["mesh"]["pp"] == 2
    second = _gang("--steps", "2", "--ckpt-dir", ckpt)[0]
    assert second["mesh"]["tp"] == 2 and second["mesh"]["pp"] == 1
    assert second["resumed_from"] == 2 and second["final_step"] == 4
    assert second["first_loss"] < first["first_loss"]  # it resumed the trained state
