#!/usr/bin/env python3
"""Updates per second of one ``chip_smoke.py`` workload phase, two checkouts
of the PyTorch/CUDA port in alternating pairs, on an NVIDIA GPU.

Run from the root of a checkout, with another checkout (e.g. the parent
commit unpacked into a directory ``.gitignore`` lists) as ``--base``::

    python3 tools/torch_workload_pairs.py --base DIR [--pairs 10] [--phase phase_binary_curve]
    python3 tools/torch_workload_pairs.py --base DIR --phase phase_workload --workload imagenet_val

Each run is a fresh process that imports ``chip_smoke`` from one checkout
and calls its ``--phase`` function twice (each call drives the workload
through its main path and checks its state) and keeps the second call's
numbers, so the two checkouts never share a process, a build or an
allocator, and neither pays its process's set-up in the rate. One warm-up run a checkout builds its
kernels first and is not counted. Pairs alternate their order (base, change;
change, base; ...). Prints one JSON object a run, then a summary: each
side's median updates/s, the median of the pairs' ratios (change over base)
and the card's name and power limit as ``nvidia-smi`` reports them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
RUN = (
    "import sys, torch; sys.path.insert(0, {root!r}); import chip_smoke; "
    "dev = torch.device('cuda', torch.cuda.current_device()); "
    "chip_smoke.{phase}({args}dev); chip_smoke.{phase}({args}dev)"
)


def run(root: Path, phase: str, workload: str = "") -> dict:
    """One process, the phase twice: the second run's JSON line (the first
    pays the process's one-time set-up: libraries loaded, allocator warmed)."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(root), phase=phase, args=f"{workload!r}, " if workload else "")],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise SystemExit(f"torch_workload_pairs: {root} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return [line for line in lines if "updates_per_s" in line][-1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="the checkout to compare against")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--phase", default="phase_binary_curve")
    parser.add_argument("--workload", default="", help="the workload name phase_workload takes")
    args = parser.parse_args()
    sides = {"base": Path(args.base).resolve(), "change": REPO}
    for side, root in sides.items():  # builds each checkout's kernels
        run(root, args.phase, args.workload)
    rates = {"base": [], "change": []}
    ratios = []
    for i in range(args.pairs):
        order = ("base", "change") if i % 2 == 0 else ("change", "base")
        pair = {}
        for side in order:
            out = run(sides[side], args.phase, args.workload)
            pair[side] = out["updates_per_s"]
            rates[side].append(out["updates_per_s"])
            print(json.dumps({
                "pair": i, "side": side, "phase": out["phase"], "updates_per_s": out["updates_per_s"],
                "update_ms": out.get("update_ms"), "launches": out.get("launches"),
            }), flush=True)
        ratios.append(pair["change"] / pair["base"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "phase": args.phase, "pairs": args.pairs,
        "base_median_updates_per_s": statistics.median(rates["base"]),
        "change_median_updates_per_s": statistics.median(rates["change"]),
        "median_pair_ratio": statistics.median(ratios),
        "ratios": ratios,
    }))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
