"""Writes the JPEG fixtures of the port's decoder and GrabCut matte into
``tests/fixtures/port_jpeg/``, with OpenCV's results beside them.

    python scripts/port_make_jpeg_fixtures.py [--out tests/fixtures/port_jpeg]

Needs cv2, which makes the reference: it is run where cv2 is installed, and
its files are checked in, so that the port's checks on a machine without
cv2 (``chip_smoke.py``'s formats phase) still hold it against cv2. Writes:

- ``small_*.jpg``: an 83x61 photo (not a multiple of any MCU) through
  ``cv2.imwrite`` with ``IMWRITE_JPEG_QUALITY`` 50 and 95, ``_PROGRESSIVE``,
  ``_OPTIMIZE``, ``_RST_INTERVAL`` 2 and each ``_SAMPLING_FACTOR`` (4:4:4,
  4:2:2, 4:2:0, 4:4:0, 4:1:1), and a grey file; beside each, ``.npy`` of
  ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` in RGB order;
- ``photo_512.jpg`` (RGB, quality 90) and ``photo_1024x768.jpg``, and
  ``photo_512_alpha.png``: the alpha of the JAX ``remove_background``
  without U2Net weights on the decoded photo (``cv2.grabCut`` on the rect
  inset by max(4, min(h, w) // 20), 5 iterations, ``GC_INIT_WITH_RECT``,
  then ``cv2.GaussianBlur(alpha, (5, 5), 0)``; cv2's RNG seeded with 0),
  grey PNG;
- ``small_grey_progressive.jpg``, and cut-off files of the 83x61 photo
  (``cut_*.jpg``): the baseline (quality 95) file at 30%, 60% and 90% of
  its bytes, the progressive one at the same three points, the
  progressive one at the end of its third scan with an EOI appended
  (unrefined coefficients, no missing data), the ``RST_INTERVAL`` 2 file
  halfway between two restart markers, the quality 50 one (4:2:0) halfway
  through its scan's data, the grey progressive one at 60%, and the
  baseline one before its first scan (inside a DQT segment), whose decode
  is None; beside each, ``.npy`` of
  cv2's ``IMREAD_UNCHANGED`` decode of the file (cv2.imread, which reads a
  cut file on as libjpeg-turbo's stdio source does: cv2.imdecode does
  not);
- ``decodes.json``: shape and SHA-256 of every file's cv2 decode under
  IMREAD_UNCHANGED, and under IMREAD_COLOR (key ``color``), null for
  None (the two photos' decodes would take 0.8 and 2.4 MB as ``.npy``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "fixtures",
                   "port_jpeg")
SMALL = (61, 83)            # height, width


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """An RGB uint8 'product photo': a shaded two-sphere toy with a band,
    standing on a wooden table before a wall, with its shadow and noise."""
    rng = np.random.default_rng(seed)
    s = min(h, w)
    y, x = np.mgrid[0:h, 0:w] / s
    cy, cx = 0.5 * h / s, 0.5 * w / s
    img = np.stack([200 - 30 * y, 190 - 25 * y, 170 - 20 * y], -1)
    img += 6 * np.sin(x * 40)[..., None]
    table = y > cy + 0.22
    wood = np.stack([125 + 18 * np.sin(x * 70 + 6 * np.sin(y * 18)), 82 + 0 * x, 48 + 0 * x], -1)
    img = np.where(table[..., None], wood, img)
    shadow = ((y - (cy + 0.27)) / 0.05) ** 2 + ((x - cx) / 0.24) ** 2 < 1
    img = np.where((shadow & table)[..., None], img * 0.55, img)
    light = np.array([-0.4, -0.5, 0.77])
    for oy, r, colour in ((cy + 0.03, 0.2, (205, 45, 40)), (cy - 0.24, 0.1, (235, 200, 60))):
        dy, dx = (y - oy) / r, (x - cx) / r
        inside = dy ** 2 + dx ** 2 < 1
        dz = np.sqrt(np.clip(1 - dy ** 2 - dx ** 2, 0, 1))
        shade = np.clip(dx * light[1] + dy * light[0] + dz * light[2], 0, 1) * 0.75 + 0.25
        c = np.array(colour, np.float64) * shade[..., None]
        if r > 0.15:                                   # a blue band round the body
            band = np.array([40, 70, 200]) * shade[..., None]
            c = np.where((np.abs(dy) < 0.18)[..., None], band, c)
        img = np.where(inside[..., None], c, img)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def markers(data: bytes, code: int) -> list[int]:
    """Offsets of every 0xFF ``code`` marker (0xD0 for any RSTn)."""
    if code == 0xD0:
        return [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == code]


def cut_files(whole: dict) -> dict:
    """Cut-off files (name -> bytes) from the whole ones (name -> bytes)."""
    base, prog = whole["small_q95"], whole["small_progressive"]
    out = {f"cut_baseline_{p}": base[:len(base) * p // 100] for p in (30, 60, 90)}
    out.update({f"cut_progressive_{p}": prog[:len(prog) * p // 100] for p in (30, 60, 90)})
    # The fourth scan's header, with the DHT cv2's encoder puts before it.
    sos = markers(prog, 0xDA)[3]
    dht = max(i for i in markers(prog, 0xC4) if i < sos)
    out["cut_progressive_scan3_eoi"] = prog[:dht] + b"\xff\xd9"
    rst = markers(whole["small_restart"], 0xD0)
    mid = len(rst) // 2
    out["cut_restart"] = whole["small_restart"][:(rst[mid] + rst[mid + 1]) // 2]
    s420 = whole["small_q50"]           # 4:2:0, cv2's default, as small_q95 and small_s420
    sos = markers(s420, 0xDA)[0]
    data_start = sos + 2 + int.from_bytes(s420[sos + 2:sos + 4], "big")
    out["cut_s420_q50"] = s420[:(data_start + len(s420)) // 2]
    grey = whole["small_grey_progressive"]
    out["cut_grey_progressive_60"] = grey[:len(grey) * 60 // 100]
    out["cut_before_scan"] = base[:len(base) * 5 // 100]
    return out


def cv2_digest(img) -> dict | None:
    if img is None:
        return None
    rgb = np.ascontiguousarray(img if img.ndim == 2 else img[..., ::-1])
    return {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def main(argv=None) -> None:
    import cv2     # the reference; the port itself never imports it

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    small = photo(*SMALL, seed=1)
    variants = {
        "small_q50": [cv2.IMWRITE_JPEG_QUALITY, 50],
        "small_q95": [cv2.IMWRITE_JPEG_QUALITY, 95],
        "small_progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        "small_optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
        "small_restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
        **{f"small_{name}": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name[1:]}")]
           for name in ("s444", "s422", "s420", "s440", "s411")},
    }
    files = {}
    for name, flags in variants.items():
        files[name] = (small, flags)
    files["small_grey"] = (small[..., 0], [])
    files["small_grey_progressive"] = (small[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files["photo_512"] = (photo(512, 512, seed=2), [cv2.IMWRITE_JPEG_QUALITY, 90])
    files["photo_1024x768"] = (photo(768, 1024, seed=3), [cv2.IMWRITE_JPEG_QUALITY, 90])
    digests, whole = {}, {}
    for name, (img, flags) in files.items():
        path = os.path.join(args.out, name + ".jpg")
        bgr = img if img.ndim == 2 else img[..., ::-1]
        if not cv2.imwrite(path, np.ascontiguousarray(bgr), flags):
            raise RuntimeError(f"cv2 could not write {path}")
        with open(path, "rb") as fh:
            whole[name] = fh.read()
    for name, data in cut_files(whole).items():
        with open(os.path.join(args.out, name + ".jpg"), "wb") as fh:
            fh.write(data)
    for name in list(files) + list(cut_files(whole)):
        path = os.path.join(args.out, name + ".jpg")
        dec = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        digests[name + ".jpg"] = {**(cv2_digest(dec) or {"shape": None, "sha256": None}),
                                  "color": cv2_digest(cv2.imread(path, cv2.IMREAD_COLOR))}
        if dec is not None and name.startswith(("small", "cut")):
            np.save(os.path.join(args.out, name + ".npy"),
                    np.ascontiguousarray(dec if dec.ndim == 2 else dec[..., ::-1]))
        if name == "photo_512":
            rgb = np.ascontiguousarray(dec[..., ::-1])
            h, w = rgb.shape[:2]
            mask = np.zeros((h, w), np.uint8)
            margin = max(4, min(h, w) // 20)
            cv2.setRNGSeed(0)
            cv2.grabCut(rgb, mask, (margin, margin, w - 2 * margin, h - 2 * margin),
                        np.zeros((1, 65)), np.zeros((1, 65)), 5, cv2.GC_INIT_WITH_RECT)
            alpha = np.where((mask == 2) | (mask == 0), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(args.out, "photo_512_alpha.png"),
                        cv2.GaussianBlur(alpha, (5, 5), 0))
    with open(os.path.join(args.out, "decodes.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"[fixtures] {len(digests)} JPEGs, {total} bytes in {args.out}")


if __name__ == "__main__":
    main()
