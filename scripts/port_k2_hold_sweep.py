"""Hold every K2 call of stage-1 CLI runs (by default ImageDream's at
128^2) against the float64 oracle, on one NVIDIA card, over a range of
seeds.

    python3 scripts/port_k2_hold_sweep.py [--seeds 0:16] [--iters 8]
        [--config imagedream.yaml] [--size 128] [--also LABEL=FLAGS ...]
        [key=value ...]

Each seed runs ``cli.main`` on ``configs/<config>`` (by default as
``chip_smoke.py``'s ImageDream day runs it: the CLI's cloud, 5,000
gaussians of opacity 0.1 in a ball, whose pixels at 128^2 composite up to
about 2,000 pairs each), with the fake guidance, every rung at ``size``^2
and no export; ``key=value`` overrides go to the CLI as they are. Every
K2 call is kept and, after the run, judged three ways with
``chip_smoke.py``'s gate (K2_RTOL of each element plus K2_ATOL of its row's
largest): the kernel against the float32 plain version (the gate of the
holds up to this script's PR), the kernel against the float64 oracle
(``rasterize_cuda.composite_backward_f64``) and the float32 plain version
against the oracle; then once more with a seeded normal cotangent in place
of the guidance's. ``--also`` adds K2 built with other nvcc flags, held
against the oracle on the same inputs. The first call that fails the
float32 gate, and the call where the kernel used the most of its gate
against float64, are saved under ``chiprun_out/k2_holds/``. Prints a line
per seed and, last, one JSON line with the largest share of the gate each
pair used and where.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0:16", help="first:end")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--config", default="imagedream.yaml")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--also", action="append", default=[],
                    help="LABEL=FLAGS: K2 built with these nvcc flags, held against float64")
    args, overrides = ap.parse_known_args()

    import torch

    if not torch.cuda.is_available():
        print("port_k2_hold_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.ops import cuda_build, rasterize, rasterize_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {label: tuple(flags.split()) for label, flags in
                (a.split("=", 1) for a in args.also)}
    for extra in [(), *variants.values()]:
        cuda_build.build(["composite_fwd", "composite_bwd"], verbose=not extra, extra=extra)
    load = cuda_build.load

    def variant_backward(extra, *a, **k):
        cuda_build.load = lambda name, argtypes: load(name, argtypes, extra)
        try:
            return rasterize_cuda.composite_backward(*a, **k)
        finally:
            cuda_build.load = load

    card = chip_smoke.card_line()
    first, end = (int(x) for x in args.seeds.split(":"))
    worst: dict = {}
    dumped, worst_call = None, None
    t0 = time.perf_counter()
    for seed in range(first, end):
        calls: list = []
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "disc.png")
            chip_smoke.write_disc_png(png, 512, seed)
            argv = ["--config", os.path.join(chip_smoke.CONFIGS, args.config),
                    f"input={png}", "save_path=sweep", f"outdir={tmp}", f"seed={seed}",
                    "fake_guidance=True", f"iters={args.iters}",
                    f"novel_resolutions=[{args.size},{args.size},{args.size}]",
                    "save_mesh=False", "final_prune=False", *overrides]
            with chip_smoke.tapped(rasterize, "composite_backward", calls,
                                   rasterize_cuda.LAST_GRID, "composite_bwd"):
                cli1.main(argv)
        per_seed = {}
        for i, c in enumerate(calls):
            args_, geo = [a.detach() for a in c["args"]], c["geo"]
            g_rand = torch.randn(args_[4].shape, device="cuda",
                                 generator=torch.Generator("cuda").manual_seed(seed * 1000 + i))
            for g_name, call_args in (("guidance", args_), ("normal", [*args_[:4], g_rand])):
                out = (c["out"].detach() if g_name == "guidance"
                       else rasterize_cuda.composite_backward(*call_args, **geo))
                rep, plain, exact = chip_smoke.k2_report(out, call_args, geo)
                for label, extra in variants.items():
                    d = variant_backward(extra, *call_args, **geo)
                    shares = chip_smoke.k2_shares(d, exact)
                    worst_row = chip_smoke.GRAD_ROWS[shares.index(max(shares))]
                    rep[f"{label}_vs_f64"] = {"share": max(shares), "row": worst_row}
                where = {"seed": seed, "call": i, "g_out": g_name,
                         "longest_tile_chunks": int(args_[2].max()),
                         "max_n_contrib": int(args_[3][:, 5].max())}
                if rep["kernel_vs_f64"]["share"] > worst.get("kernel_vs_f64",
                                                              {}).get("share", -1.0):
                    worst_call = (f"sweep worst seed{seed} call{i} {g_name}", call_args, geo,
                                  {"d_kernel": out, "d_plain": plain})
                for name, r in rep.items():
                    per_seed[name] = max(per_seed.get(name, 0.0), r["share"])
                    if r["share"] > worst.get(name, {}).get("share", -1.0):
                        worst[name] = {**where, "label": chip_smoke.composite_label(geo),
                                       "share": r["share"], "row": r["row"],
                                       "shares": r.get("shares")}
                if dumped is None and rep["kernel_vs_plain"]["share"] > 1.0:
                    dumped = chip_smoke.dump_k2_call(f"sweep seed{seed} call{i} {g_name}",
                                                     call_args, geo, d_kernel=out, d_plain=plain)
                    print(f"[sweep] seed {seed} call {i} ({g_name} cotangent) fails the float32 "
                          f"gate; inputs saved to {dumped}: {json.dumps(rep)}")
        print(f"[sweep] seed {seed}: {len(calls)} K2 calls, largest share of the gate "
              f"{json.dumps({k: round(v, 4) for k, v in per_seed.items()})}", flush=True)
    if worst_call is not None:
        tag, call_args, geo, outs = worst_call
        worst["kernel_vs_f64"]["dump"] = chip_smoke.dump_k2_call(tag, call_args, geo, **outs)
    print(f"[sweep] {end - first} seeds in {time.perf_counter() - t0:.1f} s; card '{card}'")
    print(json.dumps({"card": card, "seeds": [first, end], "worst": worst, "dump": dumped}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
