"""Launcher implementation (counterpart of
``paddle_tpu/distributed/launch/main.py``; ref: launch/main.py:21,
launch/controllers/collective.py:22 CollectiveController)."""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main"]


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch distributed training (torch.distributed ranks)",
    )
    p.add_argument("--master", default=None,
                   help="rendezvous host:port (default: 127.0.0.1 and a free "
                   "port)")
    p.add_argument("--nnodes", type=int, default=1, help="number of hosts")
    p.add_argument("--rank", type=int, default=0, help="this host's index")
    p.add_argument("--nproc", "--nproc_per_node", dest="nproc", type=int,
                   default=1, help="rank processes on this host")
    p.add_argument("--log_dir", default="log", help="per-rank log directory")
    p.add_argument("--max_restart", type=int, default=3,
                   help="restarts allowed before giving up")
    p.add_argument("--devices", default=None,
                   help="visible device ids, comma-separated")
    p.add_argument("--job_id", default="default", help="job name for logs")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class Container:
    """One managed rank process (ref: launch/job/container.py)."""

    def __init__(self, cmd: List[str], env: dict, log_path: str):
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0

    def start(self):
        os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
        if getattr(self, "_log", None) is not None:
            self._log.close()
        self._log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.cmd, env=self.env, stdout=self._log, stderr=subprocess.STDOUT
        )

    def poll(self):
        return self.proc.poll() if self.proc else None

    def terminate(self):
        if self.proc and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        if getattr(self, "_log", None) is not None:
            self._log.close()
            self._log = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _build_env(args, local_rank: int, master: str) -> dict:
    env = dict(os.environ)
    world = args.nnodes * args.nproc
    global_rank = args.rank * args.nproc + local_rank
    host, port = master.rsplit(":", 1)
    # the port's rendezvous (torch.distributed's env:// names)
    env["MASTER_ADDR"] = host
    env["MASTER_PORT"] = port
    env["WORLD_SIZE"] = str(world)
    env["RANK"] = str(global_rank)
    env["LOCAL_RANK"] = str(local_rank)
    env["LOCAL_WORLD_SIZE"] = str(args.nproc)
    # reference env surface (launch/controllers/collective.py:37)
    env["PADDLE_MASTER"] = master
    env["PADDLE_GLOBAL_SIZE"] = str(world)
    env["PADDLE_GLOBAL_RANK"] = str(global_rank)
    env["PADDLE_TRAINER_ID"] = str(global_rank)
    env["PADDLE_TRAINERS_NUM"] = str(world)
    env["PADDLE_LOCAL_RANK"] = str(local_rank)
    env["PADDLE_LOCAL_SIZE"] = str(args.nproc)
    env["PADDLE_NNODES"] = str(args.nnodes)
    env["PADDLE_JOB_ID"] = args.job_id
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return env


def launch(argv: Optional[List[str]] = None) -> int:
    """Run the job; returns the first non-zero exit code (0 = success)."""
    args = _parse_args(argv if argv is not None else sys.argv[1:])

    master = args.master or f"127.0.0.1:{_free_port()}"
    containers: List[Container] = []
    for lr in range(args.nproc):
        cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
        log_path = os.path.join(
            args.log_dir, f"{args.job_id}.rank{args.rank * args.nproc + lr}.log"
        )
        containers.append(Container(cmd, _build_env(args, lr, master), log_path))

    for c in containers:
        c.start()

    exit_code = 0
    try:
        while True:
            alive = 0
            for c in containers:
                rc = c.poll()
                if rc is None:
                    alive += 1
                elif rc != 0:
                    if c.restarts < args.max_restart:
                        c.restarts += 1
                        print(
                            f"rank process failed (exit {rc}); restart "
                            f"{c.restarts}/{args.max_restart}", file=sys.stderr,
                        )
                        c.start()
                        alive += 1
                    else:
                        exit_code = rc
                        raise KeyboardInterrupt  # tear down peers
            if alive == 0:
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        for c in containers:
            c.terminate()
        if exit_code == 0:
            exit_code = 130
    return exit_code


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
