"""Sweeps randomly cut and altered copies of the JPEG fixtures through the
port's reader and ``cv2.imread``, and counts where they disagree.

    python scripts/port_jpeg_damage_sweep.py [--seeds 1:5] [--cases 20]
        [--dir tests/fixtures/port_jpeg_variants] [--max-bytes 40000]

For each seed and each JPEG of the folder (up to ``--max-bytes`` long),
``--cases`` copies cut at a random byte after the first SOS and
``--cases`` copies with one to three random bytes changed anywhere after
SOI are written to a scratch file and read by ``read_image`` and by
``cv2.imread`` under IMREAD_UNCHANGED and IMREAD_COLOR. A read agrees when
both give the same array, or cv2 gives None and the port raises
(ValueError, or FileNotFoundError where the leading bytes are no longer a
JPEG's). Prints one line per disagreement (the first ten, each copy kept
in the scratch folder, which is removed when there is none) and a total;
exits 1 if any. Needs cv2, the
reference; ``tests/test_torch_jpeg_variants.py`` holds a fixed subset.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import cv2     # the reference; the port itself never imports it

    sys.path.insert(0, str(ROOT))
    from dreamgaussian_tpu_torch.utils.imread import read_image

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="1:5", help="first:last (exclusive)")
    ap.add_argument("--cases", type=int, default=20)
    ap.add_argument("--dir", default=str(ROOT / "tests" / "fixtures" / "port_jpeg_variants"))
    ap.add_argument("--max-bytes", type=int, default=40000)
    args = ap.parse_args(argv)
    first, last = (int(x) for x in args.seeds.split(":"))
    work = Path(tempfile.mkdtemp(prefix="jpeg_damage_"))
    path = work / "case.jpg"
    files = [p for p in sorted(Path(args.dir).glob("*.jpg"))
             if p.stat().st_size <= args.max_bytes]
    reads = bad = 0
    for seed in range(first, last):
        rng = np.random.default_rng(seed)
        for src in files:
            data = src.read_bytes()
            sos = max(data.find(b"\xff\xda"), 2)
            copies = [data[:int(rng.integers(sos, len(data)))] for _ in range(args.cases)]
            for _ in range(args.cases):
                copy = bytearray(data)
                for at in rng.integers(2, len(data), int(rng.integers(1, 4))):
                    copy[at] = int(rng.integers(0, 256))
                copies.append(bytes(copy))
            for copy in copies:
                path.write_bytes(copy)
                for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
                    reads += 1
                    want = cv2.imread(str(path), flags)
                    if want is not None and want.ndim == 3:
                        want = np.ascontiguousarray(want[..., ::-1])
                    try:
                        got = read_image(str(path), flags)
                    except (ValueError, FileNotFoundError):
                        got = None
                    same = (got is None and want is None) or (
                        got is not None and want is not None and got.shape == want.shape
                        and np.array_equal(got, want))
                    if not same:
                        bad += 1
                        if bad <= 10:
                            keep = work / f"disagree_{bad}.jpg"
                            keep.write_bytes(copy)
                            print(f"[sweep] seed {seed} {src.name} flags {flags}: port "
                                  f"{None if got is None else got.shape}, cv2 "
                                  f"{None if want is None else want.shape} ({keep})")
    os.remove(path)
    if not bad:
        os.rmdir(work)
    print(f"[sweep] seeds {first}:{last}, {len(files)} files of {args.dir}: {reads} reads, "
          f"{bad} disagree with cv2.imread")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
