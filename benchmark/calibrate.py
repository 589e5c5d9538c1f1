"""The readings that a cell's limits of `correct` are set from, at the
cell's own size, in one process a card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out _runs/calibrate.jsonl]

For each seed of --seeds, a sound run of the program: the cell's set-up,
one image of its loop (an ensemble) or the set-up's first train steps, and
every number of the check against the reference (the traffic's limits
compare some of them). A cell on several cards runs these over its ranks,
one process a card, as run.py does. For each seed of --control-seeds, on
one card: the control, the reference computed in float8 (e4m3 activations
and weights, e5m2 cotangents) in the program's place, against the float32
reference; and for a train cell the faults of its kind's `faults`, planted
in the reference. One JSON line per reading, printed and appended to
--out. Not run by the benchmark's runs.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="_runs/calibrate.jsonl")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, harness
    from benchmark.run import free_port

    spec = harness.load(ROOT, a.workload)
    chips = spec.workload["chips"]
    device = torch.device("cuda", a.rank) if torch.cuda.is_available() else torch.device("cpu")
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(row: dict) -> None:
        row.update(workload=a.workload, card=torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
        line = json.dumps(row)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    def cell(seed, mesh=None):
        return cells.make_cell(spec.workload, spec.config, spec.traffic, seed, device, mesh,
                               ROOT)

    seeds = [int(s) for s in a.seeds.split(",") if s]
    children, mesh = [], None
    if seeds and chips > 1:
        if a.rank == 0:
            a.port = free_port()
            for r in range(1, chips):
                cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", a.workload,
                       "--seeds", a.seeds, "--out", a.out, "--rank", str(r), "--port",
                       str(a.port)]
                children.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))
        mesh = harness.join(f"tcp://127.0.0.1:{a.port}", a.rank, chips, device)
    for seed in seeds:
        c = cell(seed, mesh)
        t0 = time.perf_counter()
        c.setup()
        if c.unit == "image":
            c.answers.append((0, 0, *c.predict(0)[1:]))
        c.release()
        t1 = time.perf_counter()
        if a.rank == 0:
            emit({"kind": "program", "seed": seed, "gaps": c.check(), "program_s": t1 - t0,
                  "reference_s": time.perf_counter() - t1})
        if mesh is not None:
            torch.distributed.barrier()
        del c
        cells.free_device()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if a.rank != 0:
        return 0
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        c = cell(seed)
        c.inputs()
        t0 = time.perf_counter()
        emit({"kind": "control", "seed": seed, "gaps": c.control(),
              "seconds": time.perf_counter() - t0})
        for fault, gaps in (c.faults() if hasattr(c, "faults") else {}).items():
            emit({"kind": f"fault:{fault}", "seed": seed, "gaps": gaps})
        del c
        cells.free_device()
    for child in children:
        child.wait(timeout=300)
    return 0 if all(child.returncode == 0 for child in children) else 1


if __name__ == "__main__":
    sys.exit(main())
