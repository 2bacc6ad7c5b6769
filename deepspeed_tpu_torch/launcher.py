"""Launcher (port of ``deepspeed_tpu/launcher.py``; ref:
deepspeed/launcher/runner.py + launch.py).

One process a GPU, as the reference: on each node the launcher forks
``--nproc_per_node`` ranks (default: the GPUs the node can see) with the
env :func:`build_env` sets, and :func:`deepspeed_tpu_torch.comm.
init_distributed` joins them into one process group.  A hostfile with more
than one host runs one launcher a host over ssh; ``--local_hosts N``
forks N ranks on this machine, and with ``--platform cpu`` hides the GPUs
from them, so a script that asks for gloo and ``device="cpu"`` runs as N
CPU ranks (the JAX package's local multi-host simulation).  A rank that
fails ends its siblings and the launcher exits with its code.

CLI: ``python -m deepspeed_tpu_torch.launcher [opts] script.py [args]``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

_DEFAULT_PORT = 29500


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_env(coordinator: str, world_size: int, rank: int,
              base: Optional[Dict[str, str]] = None, local_rank: int = 0,
              local_world_size: int = 1) -> Dict[str, str]:
    """Env for one rank (ref: launcher/launch.py child env): the JAX
    package's names that ``comm.init_distributed`` resolves and the
    reference's, so scripts written against either keep working."""
    env = dict(base if base is not None else os.environ)
    host, _, port = coordinator.rpartition(":")
    env["COORDINATOR_ADDRESS"] = coordinator
    env["MASTER_ADDR"], env["MASTER_PORT"] = host, port
    env["NUM_PROCESSES"] = env["WORLD_SIZE"] = str(world_size)
    env["PROCESS_ID"] = env["RANK"] = str(rank)
    env["LOCAL_RANK"] = str(local_rank)
    env["LOCAL_WORLD_SIZE"] = str(local_world_size)
    return env


def parse_hostfile(text: str) -> List[str]:
    """``host slots=N`` lines -> host list (ref: runner.py parse_hostfile).
    The slots are read for compatibility and unused: ``--nproc_per_node``
    says how many ranks a host runs."""
    hosts = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            hosts.append(line.split()[0])
    return hosts


def _gpu_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.launcher",
        description="deepspeed_tpu_torch launcher: one rank a GPU")
    p.add_argument("--hostfile", default=None,
                   help="deepspeed-style hostfile (host slots=N per line)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address (ref: --master_addr/--master_port)")
    p.add_argument("--nnodes", type=int, default=None,
                   help="number of nodes")
    p.add_argument("--node_rank", type=int, default=None,
                   help="this node's index")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks on this node (default: its GPU count)")
    p.add_argument("--local_hosts", type=int, default=0,
                   help="fork N ranks on this machine")
    p.add_argument("--platform", default=None, choices=("cpu",),
                   help="cpu: hide the GPUs from the ranks")
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def _wait_all(procs: List[subprocess.Popen]) -> int:
    """Wait for the ranks; on the first failure (or Ctrl-C) end the rest so
    a dead rank cannot leave its siblings hung in a collective (ref:
    launch.py sigkill_handler).  Returns the code of the first rank seen to
    fail (not that of a sibling ended here), else 0."""
    failed = None
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                return next((rc for rc in rcs if rc), 0)
            failed = next((rc for rc in rcs if rc not in (None, 0)), None)
            if failed is not None:
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    if failed is not None:
        return failed
    return next((p.returncode for p in procs if p.returncode), 1)


def _spawn(args, coordinator: str, nnodes: int, node_rank: int,
           nproc: int) -> List[subprocess.Popen]:
    procs = []
    for local in range(nproc):
        env = build_env(coordinator, nnodes * nproc, node_rank * nproc + local,
                        local_rank=local, local_world_size=nproc)
        if args.platform == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + list(args.script_args), env=env))
    return procs


def launch_local(args) -> int:
    """Fork ``--local_hosts`` ranks on this machine."""
    coordinator = args.coordinator or f"127.0.0.1:{free_port()}"
    return _wait_all(_spawn(args, coordinator, 1, 0, args.local_hosts))


def ssh_command(host: str, coordinator: str, num_nodes: int, node_rank: int,
                nproc_per_node: int, script: str,
                script_args: List[str]) -> List[str]:
    """argv that runs this launcher on one remote node over ssh (ref:
    runner.py's pdsh command construction)."""
    inner = " ".join(shlex.quote(tok) for tok in [
        "python", "-m", "deepspeed_tpu_torch.launcher",
        "--coordinator", coordinator, "--nnodes", str(num_nodes),
        "--node_rank", str(node_rank),
        "--nproc_per_node", str(nproc_per_node), script] + list(script_args))
    return ["ssh", "-o", "StrictHostKeyChecking=no", host, inner]


def launch_ssh(hosts: List[str], args) -> int:
    """One launcher a host over ssh (ref: PDSHRunner)."""
    coordinator = args.coordinator or f"{hosts[0]}:{_DEFAULT_PORT}"
    nproc = args.nproc_per_node or 1
    procs = [subprocess.Popen(
        ssh_command(h, coordinator, len(hosts), rank, nproc, args.script,
                    args.script_args))
        for rank, h in enumerate(hosts)]
    return _wait_all(procs)


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    if args.local_hosts > 0:
        return launch_local(args)
    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = parse_hostfile(f.read())
        if args.node_rank is None and len(hosts) > 1:
            return launch_ssh(hosts, args)
        if args.nnodes is None:
            args.nnodes = len(hosts)
        if args.coordinator is None and hosts:
            args.coordinator = f"{hosts[0]}:{_DEFAULT_PORT}"
    given = (args.coordinator is not None, args.nnodes is not None,
             args.node_rank is not None)
    if any(given) and not all(given) and not args.hostfile:
        raise SystemExit(
            "deepspeed_tpu_torch.launcher: --coordinator, --nnodes and "
            "--node_rank must be given together (or use --hostfile / "
            "--local_hosts)")
    nnodes = args.nnodes or 1
    node_rank = args.node_rank or 0
    coordinator = args.coordinator or f"127.0.0.1:{free_port()}"
    nproc = args.nproc_per_node or max(1, _gpu_count())
    return _wait_all(_spawn(args, coordinator, nnodes, node_rank, nproc))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
