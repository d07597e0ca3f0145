"""Readings the comparison's limits are set from, on a card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--control] [--fault NAME]

For each seed, in one process (a data mesh's other ranks in processes of
their own, ``ranks.py``): the cell's set-up as a run makes it (the
port's compared steps on the seed's inputs) and the reference's steps,
then the gaps as a run reads them (``sound``); with ``--control`` also
the fp8 control put in the port's place, against the reference
(``control``); with ``--fault`` the port's steps with that fault planted
(``faults.py``) instead of the sound ones; with ``--precision float32``
the port's networks in float32 (the look at where a gap comes from). One JSON line per seed on
standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from portbench import faults, harness, ranks


def readings(cell: dict, seed: int, control: bool, fault: str | None, device="cuda",
             precision: str | None = None) -> dict:
    config, traffic = harness.config(cell["config"]), harness.traffic(cell["traffic"])
    if precision:
        config["precision"]["guidance_networks"] = precision
    drv = harness.runner(traffic["kind"])
    workers = None
    if traffic.get("ranks", 1) > 1:
        workers = ranks.start(config, traffic, seed, 0.0, False, str(device), fault,
                              setup_only=True)
    try:
        run = (drv.Run(config, traffic, seed, device, False, rank=0, port=workers.port)
               if workers else drv.Run(config, traffic, seed, device, False))
        with faults.plant(fault) if fault else contextlib.nullcontext():
            run.setup()
        port = run.port_steps
        run.leave()
    finally:
        if workers:
            workers.wait()
    ref = run.reference()
    out = {"cell": cell["name"], "seed": seed, "fault": fault,
           "port_vs_reference": drv.compare(port, ref), "leaves": drv.leaf_gaps(port, ref),
           "losses": {"port": port["loss"], "reference": ref["loss"]}}
    if control:
        ctl = run.reference(control=True)
        out["control_vs_reference"] = drv.compare(ctl, ref)
        out["control_leaves"] = drv.leaf_gaps(ctl, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, choices=faults.FAULTS)
    ap.add_argument("--precision", default=None,
                    help="run the port's networks in this dtype instead (the look at a gap)")
    args = ap.parse_args(argv)
    cell = harness.cell(harness.benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.control, args.fault,
                                  precision=args.precision)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
