"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of one chip runs in this process. A cell of several chips runs one
rank process a card, which this process starts (`launch`): they meet in a
file store in a fresh directory under TMPDIR and talk over NCCL; rank 0
hands its lines back through a pipe, and this process prints them once
every rank has ended. A rank that fails ends the run at once: this
process kills the others and exits with an error.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (with --trace 1) and, last, the
numbers compared with their limits, which are also the last lines on
standard error. Without a card (or with fewer than the cell needs) the
run prints no result and exits with 2; a run in which any rank finds jax
or the JAX package among its modules, at its start or once its window
has closed, prints no result and exits with 3. `--device cpu` runs the cell on
the CPU through the port's plain routes, for the tests (gloo between rank
processes); its numbers are no device's.
"""

from __future__ import annotations

import time

T0 = time.time()  # the process's start, before the heavy imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_DEADLINE_S = 1150.0  # a rank run past this (its first run compiles) is ended
COLLECTIVE_TIMEOUT_S = 600.0


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # set by `launch` for its rank processes
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fail(code: int, message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    return code


def emit(line: dict, out=None) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on `out` (standard output)."""
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(line), file=out or sys.stdout, flush=True)


def _die_with_parent() -> None:  # a rank process ends with the process that started it
    import ctypes
    import signal

    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def launch(args, ranks: int, chips: int) -> int:
    """Start one rank process a card, wait for all, print rank 0's lines.
    The ranks start first, so that this process's look for the cards
    (which imports torch) overlaps theirs; without the cards it ends them
    and fails."""
    import shutil
    import subprocess
    import tempfile
    import threading

    store_dir = tempfile.mkdtemp(prefix="benchmark-store-")
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, lines = [], []
    try:
        for r in range(ranks):
            cmd = [sys.executable, "-m", "benchmark.run", "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace), "--device", args.device,
                   "--rank", str(r), "--world", str(ranks), "--store", os.path.join(store_dir, "store"),
                   "--t0", repr(T0)]
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, text=True, preexec_fn=_die_with_parent,
                                          stdout=subprocess.PIPE if r == 0 else sys.stderr))
        reader = threading.Thread(target=lambda: lines.extend(procs[0].stdout), daemon=True)
        reader.start()
        short = card_shortage(args.device, chips)
        if short:
            return fail(2, short)
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                code = procs[bad[0]].returncode
                return fail(3 if code == 3 else 1, f"rank {bad[0]} exited with {code}; the others are ended")
            if time.time() - T0 > RANK_DEADLINE_S:
                return fail(1, f"the ranks ran past {RANK_DEADLINE_S} s; they are ended")
            time.sleep(0.1)
        reader.join(timeout=10)
        codes = [p.returncode for p in procs]
        if any(codes):
            return fail(3 if 3 in codes else 1, f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(store_dir, ignore_errors=True)
    from benchmark.cells import forbidden_modules

    bad = forbidden_modules()
    if bad:
        return fail(3, f"forbidden modules loaded: {bad}")
    if not lines or not lines[-1].startswith("{"):
        return fail(1, "rank 0 printed no result")
    for line in lines[:-1]:
        print(line.rstrip("\n"), file=sys.stderr, flush=True)
    emit(json.loads(lines[-1]))
    return 0


def rank_comm(args):
    """(comm, device) of this process: no comm at one rank; a rank
    process joins the group over NCCL (gloo on the CPU)."""
    import torch

    if args.rank is None:
        return None, torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    import warnings
    from datetime import timedelta

    import torch.distributed as dist
    from cstone_tpu_torch.parallel.dist import DistComm

    if args.device == "cuda":
        device, backend = torch.device("cuda", args.rank), "nccl"
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), "gloo"
    # torch 2.13 marks the name the port calls deprecated in favour of one that older releases lack
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.* is deprecated", category=FutureWarning)
    dist.init_process_group(backend, init_method=f"file://{args.store}", rank=args.rank, world_size=args.world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return DistComm(args.rank, args.world, backend, device), device


def power_limit_w():
    """The card's power limit as nvidia-smi reads it (None if it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_here(args, cell) -> int:
    """This process's rank: run it; rank 0 prints the result."""
    import torch

    import cstone_tpu_torch  # noqa: F401  (the program; loaded before the check below)
    from benchmark import harness

    # one host thread a process: the step is bound by one core's launches, and
    # idle intra-op workers on the same cores spread the runs (8 threads against 1
    # on one H100: 5.32-6.72e7 particles/s against 5.60-6.51e7)
    torch.set_num_threads(1)
    from benchmark.cells import forbidden_modules

    bad = forbidden_modules()
    if bad:
        return fail(3, f"forbidden modules loaded: {bad}")
    comm, device = rank_comm(args)
    t0 = args.t0 if args.t0 is not None else T0
    try:
        rec = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace), comm, device, t0)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # peers waiting on this rank in a collective are ended by the launcher
    bad = forbidden_modules()  # every rank looks once its window has closed
    if bad and comm is None:
        return fail(3, f"forbidden modules loaded: {bad}")
    if bad:
        fail(3, f"rank {comm.rank}: forbidden modules loaded: {bad}")
        os._exit(3)  # the launcher ends the other ranks and prints no result
    if comm is not None and comm.rank != 0:
        import torch.distributed as dist

        dist.destroy_process_group()
        return 0
    print(f"benchmark: {json.dumps(rec['timing'])}", file=sys.stderr, flush=True)
    line = harness.result_line(cell, rec, bool(args.trace), device,
                               power_limit_w() if device.type == "cuda" else None)
    bad = forbidden_modules()
    if bad:
        return fail(3, f"forbidden modules loaded: {bad}")
    if comm is None:
        emit(line)
        return 0
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps(line), flush=True)  # to the launcher, which prints the compared numbers and this line
    return 0


def card_shortage(device: str, chips: int):
    """Why this machine cannot run the cell, or None."""
    if device != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} present"
    return None


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))  # fixed, inside the checkout
    from benchmark.cells import load_cell

    cell = load_cell(args.workload)
    ranks = cell["config"]["ranks"]
    if args.rank is None and ranks > 1:
        return launch(args, ranks, cell["chips"])
    short = card_shortage(args.device, cell["chips"])
    if short:
        return fail(2, short)
    return run_here(args, cell)


if __name__ == "__main__":
    sys.exit(main())
