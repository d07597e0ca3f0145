#!/usr/bin/env python
"""Batch image-to-3D over a folder of RGBA inputs, through the PyTorch port.

The port's counterpart of ``scripts/runall.py``: for each ``*_rgba.png``
under ``--dir`` it runs stage 1 (``cli.main.run``), stage 2
(``cli.main2.run``) and, with ``--video``, a 36-frame orbit GIF of the
refined mesh (``cli.render``), one input after another on one device.

    python scripts/port_runall.py --dir data --out logs [--video] [--device cpu] \\
        [--extra key=value ...]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="data")
    ap.add_argument("--out", default="logs")
    ap.add_argument("--config", default="configs/image.yaml")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra key=value overrides for both stages")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dreamgaussian_tpu_torch import resolve_device
    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.cli import main2 as cli2
    from dreamgaussian_tpu_torch.cli import render as cli_render
    from dreamgaussian_tpu_torch.utils.config import load_with_cli

    device = resolve_device(args.device)
    files = sorted(glob.glob(os.path.join(args.dir, "*_rgba.png")))
    print(f"[INFO] {len(files)} inputs")
    written = []
    for path in files:
        name = os.path.basename(path).replace("_rgba.png", "")
        print(f"===== {name} =====")
        opt = load_with_cli(args.config, [f"input={path}", f"save_path={name}",
                                          f"outdir={args.out}", *args.extra,
                                          f"device={device.type}"])
        cli1.run(opt)
        mesh = cli2.run(opt)["mesh_path"]
        written.append(mesh)
        if args.video:
            written.append(cli_render.main([mesh, "--out", os.path.join(args.out, f"{name}_orbit.gif"),
                                            "--device", device.type]))
    return written


if __name__ == "__main__":
    main()
