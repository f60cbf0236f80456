"""Readings that set a cell's limits: the program's answers and the
control's, judged by the reference at the cell's own size.

    python3 -m portbench.control --workload NAME --seeds 1,2,3 --requests 2 \
        [--control] [--out FILE]

For each seed, ``--requests`` requests are drawn as a run draws them
(``gen/traffic.py``, the window's stream) and sent through the cell's call;
with ``--control`` the call runs the program's float32 path alone (the
float64 refinement off), the precision below the one the configuration
states.  Each request's readings (``judges/``) are printed as one JSON line.
The benchmark's own runs never run the control.  Run it on the card; with
``device="cpu"`` (tests) it runs the program's plain paths.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from portbench import run as harness


def readings(workload: str, seeds, requests: int, control: bool, device=None,
             out=None) -> list:
    cell = harness.load_json("workloads", f"{workload}.json")
    config = harness.load_json("configs", f"{cell['config']}.json")
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    from portbench.gen import traffic as gen

    call = importlib.import_module(f"portbench.calls.{traffic['call']}")
    judge = importlib.import_module(f"portbench.judges.{traffic['call']}")
    net = gen.network(config)
    judge_device = "cpu" if device == "cpu" else "cuda"
    rows = []
    for seed in seeds:
        for i in range(requests):
            req = gen.draw(traffic, net, seed, i)
            t0 = time.perf_counter()
            res = call.call(net, req, traffic, device=device, control=control)
            dt = time.perf_counter() - t0
            ans = call.answer(res)
            got = judge.judge(net, req, ans, judge_device)
            row = dict(workload=workload, seed=seed, index=i, control=control,
                       seconds=dt, certified=call.certified(res), **got)
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        readings(args.workload, seeds, args.requests, args.control, out=out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
