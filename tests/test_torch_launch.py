"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
and ``spawn``, against the reference's contract
(``paddle_tpu/distributed/launch/main.py``, ``spawn.py``): the same
arguments, the rank environment (the reference's ``PADDLE_*`` names and the
port's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), per-rank
logs ``<job_id>.rank<r>.log``, restarts up to ``--max_restart``, and a
failed rank's exit code. Two gloo ranks on the CPU, each run bounded by a
timeout.
"""
import importlib
import os
import subprocess
import sys

import pytest

import torch_dist_ranks as R
from paddle_tpu_torch.distributed import spawn

tmain = importlib.import_module("paddle_tpu_torch.distributed.launch.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

RANK_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from paddle_tpu_torch.distributed import all_reduce, get_rank, init_parallel_env
init_parallel_env("cpu")
t = torch.ones(2) * (get_rank() + 1)
all_reduce(t)
print("rank", get_rank(), "of", os.environ["WORLD_SIZE"], "sum", t.tolist(),
      "trainer", os.environ["PADDLE_TRAINER_ID"], "master",
      os.environ["PADDLE_MASTER"] == os.environ["MASTER_ADDR"] + ":"
      + os.environ["MASTER_PORT"])
"""

FLAKY_SCRIPT = """
import os, sys
marker = {marker!r}
if not os.path.exists(marker):
    open(marker, "w").close()
    print("first run fails")
    sys.exit(3)
print("second run ok")
"""


def _launch(tmp_path, script, *args):
    path = tmp_path / "rank.py"
    path.write_text(script)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--log_dir", str(tmp_path / "logs"), *args, str(path)],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)


def test_two_ranks_meet_and_log_per_rank(tmp_path):
    run = _launch(tmp_path, RANK_SCRIPT.format(repo=REPO), "--nproc", "2",
                  "--job_id", "job")
    assert run.returncode == 0, run.stderr
    for r in (0, 1):
        log = (tmp_path / "logs" / f"job.rank{r}.log").read_text()
        assert (f"rank {r} of 2 sum [3.0, 3.0] trainer {r} master True"
                in log), log


def test_max_restart_relaunches_a_failed_rank(tmp_path):
    marker = str(tmp_path / "marker")
    run = _launch(tmp_path, FLAKY_SCRIPT.format(marker=marker),
                  "--max_restart", "1")
    assert run.returncode == 0, run.stderr
    assert "restart 1/1" in run.stderr
    log = (tmp_path / "logs" / "default.rank0.log").read_text()
    assert "first run fails" in log and "second run ok" in log
    os.remove(marker)
    run = _launch(tmp_path, FLAKY_SCRIPT.format(marker=marker),
                  "--max_restart", "0")
    assert run.returncode == 3


def test_arguments_are_the_references():
    args = tmain._parse_args(["--master", "10.0.0.1:6170", "--nnodes", "2",
                              "--rank", "1", "--nproc", "4", "--log_dir", "l",
                              "--max_restart", "2", "--devices", "0,1",
                              "--job_id", "j", "train.py", "--lr", "1"])
    env = tmain._build_env(args, 3, args.master)
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"]) == ("7", "8", "3")
    assert env["PADDLE_GLOBAL_RANK"] == env["PADDLE_TRAINER_ID"] == "7"
    assert env["PADDLE_TRAINERS_NUM"] == "8" and env["PADDLE_NNODES"] == "2"
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1", "6170")
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert args.training_script_args == ["--lr", "1"]


def test_spawn_sets_the_rank_env_and_raises_on_a_failed_child(tmp_path):
    with pytest.raises(RuntimeError, match=r"\(1, 5\)"):
        spawn(R.exit_on_rank1, args=(str(tmp_path),), nprocs=2,
              master="127.0.0.1:29999")
    for r in (0, 1):
        env = (tmp_path / f"env{r}.txt").read_text()
        assert (f"RANK={r} WORLD_SIZE=2 LOCAL_RANK={r} PADDLE_TRAINER_ID={r} "
                f"PADDLE_TRAINERS_NUM=2 PADDLE_LOCAL_RANK={r} "
                "MASTER_ADDR=127.0.0.1 MASTER_PORT=29999") == env
