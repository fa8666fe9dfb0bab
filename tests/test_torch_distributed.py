"""The port's gang bootstrap (tputopo_torch.distributed): the env contract
against the JAX package's on a table of env dicts, and a real 2-process
rendezvous over gloo through the TPUTOPO_* env."""

import socket

import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import run_ranks
from tputopo.workloads import distributed as jd
from tputopo_torch import distributed as td

ENVS = [
    # the reference's own cases (tests/test_distributed.py)
    {},
    {"TPUTOPO_NUM_PROCESSES": "4", "TPUTOPO_COORDINATOR": "llama-dp4-0.llama-dp4",
     "JOB_COMPLETION_INDEX": "2"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": "c:1234",
     "TPUTOPO_PROCESS_ID": "1", "JOB_COMPLETION_INDEX": "0"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": "c", "TPU_WORKER_ID": "1"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": "c", "CLOUD_TPU_TASK_ID": "1"},
    {"TPU_WORKER_ID": "3", "JOB_COMPLETION_INDEX": "2"},
    {"TPUTOPO_NUM_PROCESSES": "2"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": "c:1", "TPUTOPO_PROCESS_ID": "2"},
    # the alias, the fallback order, the single-process rule, bad values
    {"TPUTOPO_GANG_SIZE": "3", "TPUTOPO_COORDINATOR": "h", "JOB_COMPLETION_INDEX": "2"},
    {"TPUTOPO_NUM_PROCESSES": "3", "TPUTOPO_GANG_SIZE": "5", "TPUTOPO_COORDINATOR": "h",
     "TPUTOPO_PROCESS_ID": "4"},
    {"TPUTOPO_NUM_PROCESSES": "4", "TPUTOPO_COORDINATOR": "h:9", "TPU_WORKER_ID": "1",
     "CLOUD_TPU_TASK_ID": "3"},
    {"TPUTOPO_NUM_PROCESSES": "1", "TPUTOPO_PROCESS_ID": "0", "TPU_WORKER_ID": "5"},
    {"TPUTOPO_NUM_PROCESSES": "1", "TPUTOPO_PROCESS_ID": "1"},
    {"TPUTOPO_NUM_PROCESSES": "0"},
    {"TPUTOPO_NUM_PROCESSES": "two"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": "h", "JOB_COMPLETION_INDEX": "x"},
    {"TPUTOPO_NUM_PROCESSES": " 2 ", "TPUTOPO_COORDINATOR": "  ", "TPU_WORKER_ID": "1"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": " h ", "TPUTOPO_PROCESS_ID": "-1"},
    {"TPUTOPO_NUM_PROCESSES": "2", "TPUTOPO_COORDINATOR": "h", "TPUTOPO_PROCESS_ID": ""},
    {"TPUTOPO_COORDINATOR": "only-coord"},
]


def _resolve(fn, env):
    try:
        g = fn(env)
        return (g.coordinator, g.num_processes, g.process_id, g.single)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_env_contract_equals_the_reference(env):
    assert _resolve(td.process_group_from_env, env) == \
        _resolve(jd.process_group_from_env, env)


def test_default_port_and_identity_type():
    assert td.DEFAULT_PORT == jd.DEFAULT_PORT
    g = td.process_group_from_env({"TPUTOPO_NUM_PROCESSES": "2",
                                   "TPUTOPO_COORDINATOR": "c", "TPU_WORKER_ID": "1"})
    assert g == td.ProcessGroup(coordinator=f"c:{td.DEFAULT_PORT}", num_processes=2,
                                process_id=1)


def test_backend_follows_the_device():
    assert td.backend_for("cuda") == "nccl"
    assert td.backend_for(torch.device("cuda", 1)) == "nccl"
    assert td.backend_for("cpu") == "gloo"
    assert td.local_device(3, "cpu") == torch.device("cpu")


def test_rank_drives_cuda_rank_mod_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert td.local_device(6) == torch.device("cuda", 2)
    assert td.local_device(3, "cuda") == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.local_device(0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_rendezvous_through_the_gang_env(tmp_path):
    """Rank 1 finds its rank through JOB_COMPLETION_INDEX, both meet at the
    TPUTOPO_COORDINATOR over TCP, and rank 0's broadcast reaches rank 1."""
    port = _free_port()

    def env_for(rank):
        return {"TPUTOPO_NUM_PROCESSES": "2",
                "TPUTOPO_COORDINATOR": f"localhost:{port}",
                "JOB_COMPLETION_INDEX": str(rank)}

    ranks = run_ranks("rendezvous", 2, tmp_path, env_for=env_for)
    for r, got in enumerate(ranks):
        assert got == {"got": 41.0, "rank": r, "world": 2, "backend": "gloo",
                       "process_id": r}
