"""Run one cell of the benchmark of `unet_research_tpu_torch` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. Needs as many CUDA
cards as the cell asks for; without them it prints no result and exits
with 2. A cell on several cards starts one process per further card (ranks
1..N-1 of an NCCL group on localhost) and runs rank 0 itself. Set-up
(imports, the kernels' build or load, weights and data made on the card
from the seed, warm-up) is timed from this process's start. The last line
on standard output is the result (harness.py); the compared numbers and
their limits are the last lines on standard error. Exits with 3, and prints
no result, when a JAX module or the JAX package is loaded in this process.

Build and kernel caches stay inside the checkout: the port's kernels in
unet_research_tpu_torch/ops/cuda/build/, Triton and torch extensions under
_runs/cache/.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    args = parse(argv)
    cache = ROOT / "_runs" / "cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["OMP_NUM_THREADS"] = "1"  # the host's few CPU ops: one thread, no spinning pool
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    spec = harness.load(ROOT, args.workload)
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", args.rank)
    children, mesh = [], None
    try:
        if chips > 1:
            if args.rank == 0:
                args.port = free_port()
                for r in range(1, chips):
                    cmd = [sys.executable, str(Path(__file__).resolve()), "--workload",
                           args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                           "--trace", str(args.trace), "--rank", str(r), "--port", str(args.port)]
                    children.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))
            mesh = harness.join(f"tcp://127.0.0.1:{args.port}", args.rank, chips, device)
        line = harness.run(spec, args.seed, args.seconds, bool(args.trace), device, T0, mesh)
    finally:
        for child in children:
            try:
                child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
    if line is None:  # a rank other than 0
        return 0
    if any(child.returncode != 0 for child in children):
        print(f"a rank failed: exit codes {[c.returncode for c in children]}", file=sys.stderr)
        return 1
    loaded = harness.forbidden(sys.modules)
    if loaded:
        print(f"JAX or the JAX package is loaded in this process: {loaded}", file=sys.stderr)
        return 3
    harness.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
