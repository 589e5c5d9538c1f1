"""Perf ladder of the PyTorch/CUDA port: bench_gpu.py's workload over
(conv_impl, mask_impl, resize, chunk) rungs in one process (the twin of
scripts/ladder.py, with its rungs and their tags).

Usage:
    python3 scripts/ladder_torch.py                # every rung
    python3 scripts/ladder_torch.py native         # the rungs whose tag starts with 'native'
    python3 scripts/ladder_torch.py native/pair    # one rung, named by its whole tag

Each rung is bench_gpu.run: two warm-up predicts, then the best of three
timed ones with fresh generators, 300 members unless BENCH_ITERS says
otherwise; bench_gpu's shrink knobs and BENCH_DEVICE apply. The conv names
are the JAX ladder's: xla runs cuDNN (the port's conv_impl='torch'), pair
the hand-written kernel K3. Prints one JSON line per rung (rung,
passes_per_sec, compile_s = the warm-ups' seconds, times, the launches of
each timed call, the device programs and whether the timed calls replayed
the warm-up's capture), then the summary table. A failed rung prints its error
line and the walk goes on; the process then exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_gpu  # noqa: E402

# tag, conv_impl, mask_impl, resize (0 = native), chunk
RUNGS = [
    ("native/default",        "xla",  "elementwise", 0,   16),
    ("native/default,c32",    "xla",  "elementwise", 0,   32),
    ("native/default,c64",    "xla",  "elementwise", 0,   64),
    ("native/fused",          "xla",  "fused",       0,   16),
    ("native/pair",           "pair", "elementwise", 0,   16),
    ("native/pair+fused",     "pair", "fused",       0,   16),
    ("native/pair+fused,c32", "pair", "fused",       0,   32),
    ("r256/default",          "xla",  "elementwise", 256, 16),
    ("r256/default,c64",      "xla",  "elementwise", 256, 64),
    ("r256/default,c128",     "xla",  "elementwise", 256, 128),
    ("r256/fused,c64",        "xla",  "fused",       256, 64),
    ("r256/pair",             "pair", "elementwise", 256, 16),
    ("r256/pair+fused",       "pair", "fused",       256, 16),
    ("r256/pair+fused,c64",   "pair", "fused",       256, 64),
    # the chunk frontier at resize 256 (`chunk256`)
    ("chunk256/c192",         "xla",  "elementwise", 256, 192),
    ("chunk256/c256",         "xla",  "elementwise", 256, 256),
    ("chunk256/c384",         "xla",  "elementwise", 256, 384),
    ("chunk256/c512",         "xla",  "elementwise", 256, 512),
    # 1000-member finals (run with BENCH_ITERS=1000)
    ("iters1k/c128",          "xla",  "elementwise", 256, 128),
    ("iters1k/c200",          "xla",  "elementwise", 256, 200),
    ("iters1k/c250",          "xla",  "elementwise", 256, 250),
]


def select(sel: str) -> list:
    """The rung whose tag is `sel`, else the rungs whose tags start with it."""
    return [r for r in RUNGS if r[0] == sel] or [r for r in RUNGS if r[0].startswith(sel)]


def run_rung(rung: tuple, base: bench_gpu.Workload) -> dict:
    tag, conv, mask, resize, chunk = rung
    out = bench_gpu.run(dataclasses.replace(base, resize=resize, chunk=chunk), conv, mask)
    return {"rung": tag, "pipeline": bench_gpu.pipeline_name(conv, mask),
            "passes_per_sec": out["passes_per_s"], "compile_s": sum(out["warmup_s"]),
            "times": out["times"], "launches": out["launches"], "programs": out["programs"],
            "program_reused": out["program_reused"]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sel = argv[0] if argv else ""
    rungs = select(sel)
    if not rungs:
        print(f"ladder: no rung matches {sel!r}", file=sys.stderr)
        return 2
    base = bench_gpu.Workload.from_env(iters=300)
    bench_gpu.claim_devices(base, int(os.environ.get("BENCH_ATTEMPTS", 3)),
                            float(os.environ.get("BENCH_RETRY_SLEEP", 120)))
    print(f"ladder: device={base.device} card={bench_gpu.card(base)}", file=sys.stderr, flush=True)
    results, failed = {}, []
    for rung in rungs:
        try:
            row = run_rung(rung, base)
        except Exception as e:  # a failed rung must not end the walk
            traceback.print_exc()
            print(json.dumps({"rung": rung[0], "error": repr(e)[:300]}), flush=True)
            failed.append(rung[0])
            continue
        results[rung[0]] = row["passes_per_sec"]
        print(json.dumps(row), flush=True)
    print("== ladder summary ==")
    for tag, pps in sorted(results.items(), key=lambda kv: -kv[1]):
        print(f"{tag:24s} {pps:8.1f} passes/s")
    for tag in failed:
        print(f"{tag:24s}   failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
