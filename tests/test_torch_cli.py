"""``python -m tputopo_torch`` (its ``allreduce`` and ``train``
subcommands) on the CPU: the reference CLI's JSON keys and exit codes,
resume, a token corpus, a 2-process gang, and SIGTERM preemption."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tputopo.workloads import collective as jc
from tputopo.workloads import validate as jv
from tputopo_torch import checkpoint as ck
from tputopo_torch.__main__ import main
from tputopo_torch.data import write_tokens

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The keys the reference's ``train`` prints (tputopo/workloads/__main__.py).
TRAIN_KEYS = {"devices", "mesh", "steps", "resumed_from", "final_step", "preempted",
              "first_loss", "last_loss"}
SMALL = ["--device", "cpu", "--seq", "32", "--batch", "2"]


@pytest.fixture(autouse=True)
def single_process_env(monkeypatch):
    for name in ("TPUTOPO_NUM_PROCESSES", "TPUTOPO_GANG_SIZE", "TPUTOPO_PROCESS_ID",
                 "TPUTOPO_COORDINATOR", "TPU_SLICE_TOPOLOGY", "TPU_ACCELERATOR_TYPE"):
        monkeypatch.delenv(name, raising=False)


def _json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.strip()][-1])


def test_allreduce_prints_the_reference_keys(capsys):
    assert main(["allreduce", "--device", "cpu", "--topology", "h100:1",
                 "--payload-mb", "0.25", "--iters", "2"]) == 0
    got = _json(capsys.readouterr().out)
    ref = jv.ValidationReport("v5e:1x1", 1.0, jc.AllReduceResult(1, 1.0, 1.0, 1.0, 1.0))
    assert set(got) == set(ref.to_dict())
    assert got["topology"] == "h100:1" and got["predicted_gbps"] == 0.0


def test_allreduce_topology_from_the_injected_env(monkeypatch, capsys):
    monkeypatch.setenv("TPU_SLICE_TOPOLOGY", "1")
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", "h100-8")
    assert main(["allreduce", "--device", "cpu", "--payload-mb", "0.25",
                 "--iters", "2"]) == 0
    assert _json(capsys.readouterr().out)["topology"] == "h100:1"
    assert main(["allreduce", "--device", "cpu", "--min-efficiency", "0.5",
                 "--payload-mb", "0.25", "--iters", "2"]) == 1  # predicted 0
    monkeypatch.delenv("TPU_SLICE_TOPOLOGY")
    assert main(["allreduce", "--device", "cpu"]) == 2
    assert main(["allreduce", "--device", "cpu", "--topology", "h100:9"]) == 2


def test_train_resume_and_profile(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert main(["train", *SMALL, "--steps", "3", "--ckpt-dir", ckpt]) == 0
    first = _json(capsys.readouterr().out)
    assert set(first) == TRAIN_KEYS
    assert first["mesh"] == {"pp": 1, "dp": 1, "sp": 1, "ep": 1, "tp": 1}
    assert first["final_step"] == 3 and first["resumed_from"] is None
    assert first["last_loss"] < first["first_loss"]  # memorization
    assert ck.latest_step(ckpt) == 3
    prof = tmp_path / "trace"
    assert main(["train", *SMALL, "--steps", "2", "--ckpt-dir", ckpt,
                 "--profile", str(prof)]) == 0
    second = _json(capsys.readouterr().out)
    assert second["resumed_from"] == 3 and second["final_step"] == 5
    assert (prof / "trace_rank0.json").stat().st_size > 0


def test_train_on_a_token_corpus(tmp_path, capsys):
    corpus = str(tmp_path / "tokens.bin")
    write_tokens(corpus, np.random.default_rng(0).integers(0, 2048, 4096))
    assert main(["train", *SMALL, "--steps", "2", "--data", corpus, "--accum", "2"]) == 0
    got = _json(capsys.readouterr().out)
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
    write_tokens(corpus, [0, 2048, 5] * 100)
    assert main(["train", *SMALL, "--steps", "1", "--data", corpus]) == 2
    assert "token id 2048 >= vocab 2048" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--experts", "4"], ["--ep", "2"], ["--pp", "2"],
                                   ["--sp", "2"], ["--lora-rank", "4"]])
def test_unported_flags_exit_2_naming_the_later_slice(flags, capsys):
    assert main(["train", *SMALL, *flags]) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_bad_configuration_exits_2(monkeypatch, capsys):
    assert main(["train", *SMALL, "--tp", "3"]) == 2  # 3 does not divide 1 device
    monkeypatch.setenv("TPUTOPO_NUM_PROCESSES", "2")
    assert main(["train", *SMALL]) == 2
    assert "TPUTOPO_COORDINATOR" in capsys.readouterr().err


def _cmd(*args) -> list[str]:
    return [sys.executable, "-m", "tputopo_torch", *args]


def _env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    for name in ("TPUTOPO_NUM_PROCESSES", "TPUTOPO_PROCESS_ID", "TPUTOPO_COORDINATOR"):
        if name not in extra:
            env.pop(name, None)
    return env


def test_two_process_gang_via_env(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        _cmd("train", *SMALL, "--steps", "2", "--ckpt-dir", str(tmp_path)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(TPUTOPO_NUM_PROCESSES="2", TPUTOPO_COORDINATOR=f"localhost:{port}",
                 JOB_COMPLETION_INDEX=str(rank)))
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(_json(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert outs[0] == outs[1]  # one global loss, agreed by both ranks
    assert outs[0]["devices"] == 2 and outs[0]["mesh"]["tp"] == 2
    assert outs[0]["last_loss"] < outs[0]["first_loss"]
    assert ck.latest_step(tmp_path) == 2


def test_sigterm_checkpoints_and_exits_zero(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.Popen(_cmd("train", *SMALL, "--steps", "500000", "--ckpt-dir", ckpt,
                                 "--save-every", "20"),
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if ck.latest_step(ckpt) is not None:
                break
            if proc.poll() is not None:
                raise AssertionError(f"train exited early: {proc.communicate()[1][-2000:]}")
            time.sleep(0.2)
        else:
            raise AssertionError("no checkpoint appeared before the deadline")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-2000:]
    report = _json(stdout)
    assert report["preempted"] is True
    assert 0 < report["final_step"] < 500_000
    assert ck.latest_step(ckpt) == report["final_step"]
    res = subprocess.run(_cmd("train", *SMALL, "--steps", "2", "--ckpt-dir", ckpt),
                         cwd=REPO, capture_output=True, text=True, timeout=120, env=_env())
    assert res.returncode == 0, res.stderr[-2000:]
    again = _json(res.stdout)
    assert again["resumed_from"] == report["final_step"] and again["preempted"] is False
