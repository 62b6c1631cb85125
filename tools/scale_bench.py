#!/usr/bin/env python
"""Scaling sweep: run bench.main over a grid of chain counts / gradient modes
and print a table of iters/s and ESS/s. Used to pick the throughput-optimal
batch size per device (the axis the reference doesn't have). Needs a GPU,
as bench.py does.

Usage: python tools/scale_bench.py [nchains=256,1024,4096] [workload=curved]
       [grad_mode=nuts|chees|both] [timed_iters=4000] [burn_iters=2000]
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def run():
    kwargs = {}
    for arg in sys.argv[1:]:
        if "=" in arg:
            k, v = arg.split("=", 1)
            kwargs[k] = v
    chain_grid = [int(x) for x in kwargs.pop("nchains", "256,1024,4096").split(",")]
    grad_mode = kwargs.pop("grad_mode", "nuts")
    modes = ["nuts", "chees"] if grad_mode == "both" else [grad_mode]
    common = {k: (int(v) if v.isdigit() else v) for k, v in kwargs.items()}

    rows = []
    for mode in modes:
        for nc in chain_grid:
            r = bench.main(nchains=nc, grad_mode=mode, **common)
            r["grad_mode"] = mode
            rows.append(r)
            print(json.dumps(r), file=sys.stderr)

    hdr = f"{'mode':>6} {'nchains':>8} {'iters/s':>10} {'ESS/s':>10} {'vs_base':>8}"
    print(hdr, file=sys.stderr)
    for r in rows:
        print(
            f"{r['grad_mode']:>6} {r['nchains']:>8} {r['iters_per_sec']:>10} "
            f"{r['value']:>10} {str(r.get('vs_baseline')):>8}",
            file=sys.stderr,
        )
    best = max(rows, key=lambda r: r["value"])
    print(json.dumps(best))
    return rows


if __name__ == "__main__":
    run()
