"""Readings that a cell's limits are set from, in one process: the check's
numbers for the program on a run of seeds, and for the reference put in
the program's place in the nearest lower precision (the control: path
weights, throughput and radiance in bfloat16) and with each planted
fault: half of the samples left out, the mean taken over the rest
("half"); the produced answer altered by 1% ("altered"); for training a
step that returns its state unchanged ("unchanged") and each gradient
put into the wrong table row ("rows").

    python3 drtbench/readings.py --workload cbox-train --seed0 100 \
        --seeds 12 --faults 3 --seconds 3

One JSON line a reading on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from drtbench import check, harness  # noqa: E402


def next_row(g):
    """Each albedo row's gradient put into the next row (the last into the
    first): an accumulator that indexes its rows wrongly."""
    return [g[0].roll(1, 0), g[1]]


def main(argv=None, config_over=None, traffic_over=None, checks_over=None):
    """Print the readings; the overrides (as `harness.run` takes them) let
    a test rehearse at a small shape."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3,
                    help="seeds (the first ones) read with each fault")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="window of a render cell: it must pass the "
                         "check's image_span")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from drtbench.reference.image import Reference

    cell = harness.Cell(args.workload, config_over, traffic_over, checks_over)
    device = torch.device(args.device)
    driver = harness.load_module(
        harness.BENCH / "drivers" / f"{cell.traffic['driver']}.py",
        "drtbench_driver")
    ref = Reference(cell.config, device)
    half_cfg = json.loads(json.dumps(cell.config))
    half_cfg["render"]["spp"] //= 2
    half_cfg["render"]["spp_chunks"] = 1
    half = Reference(half_cfg, device)

    def emit(seed, what, numbers, **extra):
        print(json.dumps({"workload": cell.name, "seed": seed, "what": what,
                          **numbers, **extra}), flush=True)

    for k in range(args.seeds):
        seed = args.seed0 + k
        t0 = time.perf_counter()
        loop = driver.Loop(cell, seed, device)
        t1 = time.perf_counter()
        if loop.kind == "render":
            harness.window(loop, args.seconds)
        loop.release()
        t2 = time.perf_counter()
        if loop.kind == "render":
            numbers = loop.judge(ref, cell.checks)
        else:
            r = check.reference_steps(ref, cell.traffic, seed)
            numbers = loop.judge(ref, cell.checks, ref=r)
        emit(seed, "program", numbers, setup_s=t1 - t0,
             check_s=time.perf_counter() - t2)
        if k >= args.faults:
            continue
        if loop.kind == "render":
            seeds = [s for s, _ in loop.kept]
            emit(seed, "control", loop.judge(ref, cell.checks,
                 check.reference_pixels(ref, seeds, cell.checks, seed,
                                        torch.bfloat16)))
            emit(seed, "half", loop.judge(ref, cell.checks,
                 check.reference_pixels(half, seeds, cell.checks, seed)))
            emit(seed, "altered", loop.judge(ref, cell.checks,
                 [(s, img * 1.01) for s, img in loop.kept]))
        else:
            t = cell.traffic

            def judge(what, steps):
                emit(seed, what, loop.judge(ref, cell.checks, steps, r))

            judge("control", check.reference_steps(ref, t, seed,
                                                   torch.bfloat16))
            judge("half", check.reference_steps(half, t, seed))
            judge("rows", check.reference_steps(ref, t, seed,
                                                grad_fault=next_row))
            judge("unchanged", r._replace(
                mu=[torch.zeros_like(x) for x in r.mu],
                nu=[torch.zeros_like(x) for x in r.nu], after=r.start))
            judge("altered", r._replace(losses=[x * 1.01 for x in r.losses]))
        del loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
