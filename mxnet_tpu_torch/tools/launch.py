#!/usr/bin/env python
"""Distributed job launcher (counterpart of ``tools/launch.py``;
reference: the dmlc-core tracker driving local/ssh/mpi process groups).

Starts N worker processes with the reference's ``DMLC_*`` contract
(``DMLC_ROLE``, ``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``,
``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER``, ``DMLC_WORKER_ID``); each
worker's ``mx.kv.create("dist_*")`` joins them through the rendezvous
store that worker 0 serves at the root address, and every worker runs
a parameter-server shard of its own.

    python -m mxnet_tpu_torch.tools.launch -n 2 [--cpu] python train.py ...
    python mxnet_tpu_torch/tools/launch.py -n 4 --launcher ssh -H hosts \\
        python train.py ...

``local`` starts the workers here; ``ssh`` one per hostfile line with
the variables inlined into the remote command (worker 0's host serves
the rendezvous); ``mpi`` hands placement to ``mpirun`` (ranks read
``OMPI_COMM_WORLD_RANK``/``PMI_RANK``).  ``--cpu`` runs the workers on
the host (``MXNET_DEFAULT_CTX=cpu``, no card visible); without it every
worker's default context is ``cuda:0``, so workers on a one-card
machine share the card.  ``--max-restarts K`` (local) relaunches a
worker that exits non-zero up to K times: for idempotent scripts that
resume from their own checkpoint (a crashed worker's shard comes back
empty; ``DistKVStore.num_dead_node`` detects the loss).  The exit code
is the first non-zero one of the workers, else 0.
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import time


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env(args, rank, root_uri, port):
    env = {
        "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": root_uri,
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": "0",
    }
    if rank is not None:
        env["DMLC_WORKER_ID"] = str(rank)
    if args.cpu:
        env["MXNET_DEFAULT_CTX"] = "cpu"
        env["CUDA_VISIBLE_DEVICES"] = ""
    for kv in args.env:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def _launch_local(args):
    port = args.port or _free_port()

    def spawn(rank):
        env = dict(os.environ)
        env.update(_worker_env(args, rank, "127.0.0.1", port))
        return subprocess.Popen(args.command, env=env)

    procs = [spawn(r) for r in range(args.num_workers)]
    if not args.max_restarts:
        return procs
    # relaunch a non-zero exit up to --max-restarts times per rank
    budget = [args.max_restarts] * args.num_workers
    while True:
        live = [p for p in procs if p.poll() is None]
        restarted = False
        for r, p in enumerate(procs):
            if p.poll() is not None and p.returncode and budget[r] > 0:
                budget[r] -= 1
                sys.stderr.write(
                    f"[launch] worker {r} exited rc={p.returncode}; "
                    f"restarting ({budget[r]} retries left)\n")
                procs[r] = spawn(r)
                restarted = True
        if not live and not restarted:
            return procs
        time.sleep(0.5)


def _launch_ssh(args):
    """One worker per hostfile line (``host[:ssh_port]``); the
    variables are inlined into the remote command."""
    if not args.hostfile:
        raise SystemExit("--launcher ssh requires -H/--hostfile")
    with open(args.hostfile) as f:
        hosts = [h for h in (ln.strip() for ln in f)
                 if h and not h.startswith("#")]
    if len(hosts) < args.num_workers:
        raise SystemExit(
            f"hostfile has {len(hosts)} hosts < -n {args.num_workers}")
    root_uri = hosts[0].split(":")[0]
    port = args.port or 9099
    procs = []
    for rank in range(args.num_workers):
        host, _, ssh_port = hosts[rank].partition(":")
        env = _worker_env(args, rank, root_uri, port)
        env_str = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        remote = (f"cd {shlex.quote(args.workdir or '.')} && env {env_str} "
                  + " ".join(shlex.quote(c) for c in args.command))
        ssh_cmd = [args.ssh_cmd, "-o", "StrictHostKeyChecking=no"]
        if ssh_port:
            ssh_cmd += ["-p", ssh_port]
        procs.append(subprocess.Popen(ssh_cmd + [host, remote]))
    return procs


def _launch_mpi(args):
    """``mpirun`` places the ranks; each reads its rank from the MPI
    runtime's variables."""
    env = _worker_env(args, None, args.root_uri or "127.0.0.1",
                      args.port or 9099)
    flags = []
    for k, v in env.items():
        flags += ["-x", f"{k}={v}"]
    cmd = ([args.mpirun_cmd, "-n", str(args.num_workers)] + flags
           + ["--allow-run-as-root"] + list(args.command))
    return [subprocess.Popen(cmd)]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="launch a multi-worker mxnet_tpu_torch job")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "mpi"])
    ap.add_argument("-H", "--hostfile", default=None,
                    help="ssh mode: one host[:port] per line")
    ap.add_argument("--ssh-cmd", default="ssh",
                    help="the ssh binary (tests substitute a shim)")
    ap.add_argument("--mpirun-cmd", default="mpirun")
    ap.add_argument("--root-uri", default=None,
                    help="rendezvous address override")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--workdir", default=None,
                    help="ssh mode: remote working directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run the workers on the host, not the card")
    ap.add_argument("--env", action="append", default=[],
                    help="extra KEY=VALUE for the workers")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="local mode: relaunch a worker that exits "
                         "non-zero up to K times")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    launcher = {"local": _launch_local, "ssh": _launch_ssh,
                "mpi": _launch_mpi}[args.launcher]
    procs = launcher(args)
    rc = 0
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
