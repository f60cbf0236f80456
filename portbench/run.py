"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell ``portbench/workloads/NAME.json``
names a configuration (``configs/``), a traffic mix (``traffic/``), the
chips it needs and the limits of its correctness check; ``BENCHMARK.json``
says which metrics the cell reports, and each metric is read by the file
of its name under ``e2e/`` or ``metrics/``.

A run: generate the configuration's network, run one warm-up request at
the cell's shapes (set-up ends there), then a closed loop of one caller
for ``--seconds`` (``--trace 0``), or a bounded number of requests under
the profiler (``--trace 1``).  Each request is drawn from ``(seed, index)``
(``gen/traffic.py``) and goes through one public entry of the program
(``calls/``).  Once the loop has ended and the device's peak memory has
been read, every request's answer is judged against the plain reference
(``judges/``, ``reference.py``); the numbers compared are printed beside
their limits as the last lines of standard error and under ``checks``, the
last key of the result line.  The last line of standard output is the
result, a JSON object.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.monotonic()
ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cfmm_routing_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def load_json(*parts) -> dict:
    with open(ROOT.joinpath(*parts)) as f:
        return json.load(f)


def reader(folder: str, name: str):
    """The ``read`` function of ``portbench/<folder>/<name>.py``."""
    path = ROOT / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones:
    the entries that list the cell, or list no cells; a per-layer entry
    without a list follows the cells of the end-to-end metric it moves."""
    e2e = bench["end_to_end"]

    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    if not trace:
        return [m for m in e2e if listed(m) in (True, None)]
    mine = {m["name"] for m in e2e if listed(m) in (True, None)}
    return [m for m in bench["per_layer"]
            if listed(m) or (listed(m) is None and m["moves"] in mine)]


class Run:
    """Everything a reader may read of one run."""

    def __init__(self, cell, config, traffic, net):
        self.cell, self.config, self.traffic, self.net = cell, config, traffic, net
        self.requests = []
        self.setup_s = None
        self.window_s = None
        self.trace = None
        self.launches = {}


def drive(run: Run, call, seed: int, index: int, stream: int, device, recorder=None):
    """One request: draw it, call the program, keep the answer."""
    from portbench.gen import traffic as gen

    req = gen.draw(run.traffic, run.net, seed, index, stream)
    rec = dict(index=index, req=req, error=None, certified=False, answer=None)
    t0 = time.perf_counter()
    try:
        if recorder is not None:
            with recorder.request():
                out = call.call(run.net, req, run.traffic, device=device)
        else:
            out = call.call(run.net, req, run.traffic, device=device)
    except Exception as exc:  # a failed request is counted, the run goes on
        rec["error"] = f"{type(exc).__name__}: {exc}"
        out = None
    rec["t_return"] = time.perf_counter()
    rec["latency_s"] = rec["t_return"] - t0
    if out is not None:
        rec["certified"] = call.certified(out)
        rec["answer"] = call.answer(out)
    return rec


def judge_all(run: Run, judge, limits: dict, device) -> tuple:
    """Judge every answer against the reference; returns (worst readings,
    judged, wrong).  A wrong answer is one whose readings pass a limit."""
    worst = {k: 0.0 for k in limits}
    judged = wrong = 0
    for rec in run.requests:
        if rec["answer"] is None:
            continue
        got = judge.judge(run.net, rec["req"], rec["answer"], device)
        rec["readings"] = got
        judged += 1
        rec["wrong"] = not all(got[k] <= limits[k] for k in limits)  # NaN fails too
        wrong += rec["wrong"]
        for k in limits:
            worst[k] = got[k] if not got[k] <= worst[k] else worst[k]
    return worst, judged, wrong


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv=None, device: str | None = None) -> int:
    """``device``: None runs on the card (and refuses to run without one);
    ``"cpu"`` runs the program's plain paths on the CPU, for tests."""
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = load_json("workloads", f"{args.workload}.json")
    config = load_json("configs", f"{cell['config']}.json")
    traffic = load_json("traffic", f"{cell['traffic']}.json")

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    cuda = device is None

    from portbench.gen import traffic as gen

    call = importlib.import_module(f"portbench.calls.{traffic['call']}")
    judge = importlib.import_module(f"portbench.judges.{traffic['call']}")
    import cfmm_routing_tpu_torch  # noqa: F401  (fails early without the program)
    from cfmm_routing_tpu_torch.ops import _build

    net = gen.network(config)
    run = Run(cell, config, traffic, net)

    # warm-up: one request at the cell's shapes (kernels built or loaded)
    warm = drive(run, call, args.seed, 0, gen.WARMUP, device)
    if warm["error"] is not None:
        raise RuntimeError(f"the warm-up request failed: {warm['error']}")
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    run.setup_s = process_age_s()

    before = dict(_build.LAUNCHES)
    if args.trace:
        from portbench.trace import Recorder

        recorder = Recorder(cuda)
        t0 = time.perf_counter()
        with recorder.window():
            for i in range(int(traffic["trace_requests"])):
                run.requests.append(drive(run, call, args.seed, i, gen.WINDOW,
                                          device, recorder))
        run.window_s = time.perf_counter() - t0
        run.trace = recorder.result
    else:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < args.seconds:
            run.requests.append(drive(run, call, args.seed, i, gen.WINDOW, device))
            i += 1
        run.window_s = run.requests[-1]["t_return"] - t0
    run.launches = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}

    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell["limits"]
    worst, judged, wrong = judge_all(run, judge, limits, "cuda" if cuda else "cpu")
    raised = sum(1 for r in run.requests if r["error"] is not None)
    uncertified = sum(1 for r in run.requests
                      if r["error"] is None and not r["certified"])
    # the product is a certified route: one that raised or that the program
    # could not certify never came, and one the reference rejects is wrong
    correct = raised == 0 and uncertified == 0 and wrong == 0 and judged > 0

    metrics = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        folder = "metrics" if args.trace else "e2e"
        value = reader(folder, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print("portbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3

    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(run.requests),
              "failed": sum(1 for r in run.requests if r["error"] is not None
                            or not r["certified"] or r.get("wrong")),
              "metrics": metrics,
              "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_ns / 1e9
        dev["window_s"] = run.trace.window_ns / 1e9
        result["breakdown"] = run.trace.breakdown()
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    result["checks"] = checks

    lat = sorted(r["latency_s"] for r in run.requests)
    print(f"portbench: {args.workload} seed {args.seed}: {len(run.requests)} "
          f"requests in {run.window_s:.3f} s, {raised} raised, {uncertified} "
          f"not certified, {wrong} judged wrong of {judged}; latency samples "
          f"{len(lat)}, min {lat[0]:.4f} s, max {lat[-1]:.4f} s; set-up "
          f"{run.setup_s:.3f} s; launches {run.launches}", file=sys.stderr)
    for r in run.requests:
        if r["error"] is not None:
            print(f"portbench: request {r['index']} raised {r['error']}",
                  file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']:.6e} limit {v['limit']:.6e}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
