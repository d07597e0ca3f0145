"""Writes the TIFF fixtures of the port's reader into
``tests/fixtures/port_tiff/``, with cv2's decodes of them beside.

    python scripts/port_make_tiff_fixtures.py [--set tiff|codecs] [--out DIR]

(``--set codecs`` writes the codec set below into
``tests/fixtures/port_tiff_codecs/``.)

Needs cv2 (OpenCV 5.0 with its libtiff 4.7), which makes the reference, and
Pillow (libtiff, libjpeg), which writes some of the files: it is run where
both are installed, and its files are checked in, so that the port's checks
on a machine without them (``chip_smoke.py``'s formats phase, the card
tests) still hold the port's reader against cv2. At 83x61 from the toy photo
of ``scripts/port_make_jpeg_fixtures.py``:

- written by Pillow (libtiff): RGB uncompressed, LZW, Deflate and PackBits;
  RGBA LZW (unassociated alpha, which cv2 premultiplies); grey 8-bit,
  16-bit and 32-bit float; grey with alpha (``LA``, one channel in cv2);
  an 8-bit palette; CMYK; CIELab; bilevel CCITT Modified Huffman, its
  word-aligned variant, T.4 1-D and 2-D, and T.6;
- written by cv2: 16-bit RGB and RGBA (LZW);
- written by ``tests/torch_image_files.py`` from the TIFF 6.0
  specification: LZW with predictor 2, Deflate (32946) with predictor 2,
  32-bit float RGB with predictor 3; JPEG-in-TIFF strips at 4:2:0 and
  4:4:4 (Pillow's libjpeg streams with their tables moved to JPEGTables);
  Orientation 3 and 6 (cv2.imread returns None for the second); 32x32 tiles with LZW and with JPEG; PlanarConfiguration 2;
  a big-endian 16-bit file; BigTIFF; uncompressed YCbCr at 2x2 with
  ReferenceBlackWhite; associated alpha; MinIsWhite at 1, 2 and 4 bits (cv2
  reads the first, not the others); a 4-bit palette; two pages; and a T.6
  strip with FillOrder 2;
- ``photo_512_rgba.tif``: the toy photo with its matte as unassociated
  alpha, LZW with predictor 2 in strips of 16 rows (a cut-out as image
  editors export it), and ``photo_1024x768_jpeg.tif``: JPEG-in-TIFF at
  4:2:0, quality 90, in strips of 16 rows;
- ``sphere_tiff.obj``, ``.mtl`` and ``sphere_tiff.tif``: a UV sphere (32 x
  16 segments) whose ``map_Kd`` is a 128^2 RGB TIFF in 64x64 LZW tiles;
- ``decodes.json``: for every image the shape, dtype and SHA-256 of
  ``cv2.imread`` under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``, channels
  in RGB order, or null where cv2 returns None; ``small_decodes.npz``: the
  83x61 files' 8-bit ``IMREAD_UNCHANGED`` arrays.

The codec set, at 83x61 from the toy photo (its HDR form from
``port_make_image_fixtures.hdr_photo``), stored the same way:

- written by cv2 from float32: SGILog and SGILog24 LogLuv (3 channels) and
  SGILog LogL (1 channel, which cv2 reads back as int8), and
  ``logluv_256.tif``, a 256^2 SGILog file for the decode time on the card;
- written by ``tests/torch_image_files.py``: LogLuv in 32x32 tiles, a
  4-bit palette in ThunderScan's coding, a NeXT-coded 2-bit grey file
  (None: cv2 reads no NeXT file), and 10-, 12- and 14-bit samples (RGB
  uncompressed, RGB LZW in strips, grey in tiles, big-endian RGBA, signed
  grey).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.normpath(os.path.join(ROOT, "tests", "fixtures", "port_tiff"))
CODECS_OUT = os.path.normpath(os.path.join(ROOT, "tests", "fixtures", "port_tiff_codecs"))
SMALL = (61, 83)            # height, width
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_image_files as F                            # noqa: E402
from port_make_image_fixtures import toy_alpha           # noqa: E402
from port_make_jpeg_fixtures import photo                # noqa: E402


def pillow(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def strips_of(data: bytes) -> tuple[list, dict]:
    """The strips of a one-page TIFF and its first IFD's fields."""
    from dreamgaussian_tpu_torch.utils.tiff import _Ifd

    d = _Ifd(data)
    return [data[o:o + c] for o, c in zip(d.all(273), d.all(279))], d.fields


def sphere_obj(name: str, texture: str, segments: int = 32, rings: int = 16) -> tuple:
    """A unit UV sphere as OBJ text (positions, UVs, normals) and its MTL."""
    th = np.linspace(0, np.pi, rings + 1)
    ph = np.linspace(0, 2 * np.pi, segments + 1)
    t, p = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    uv = np.stack([p / (2 * np.pi), 1 - t / np.pi], -1).reshape(-1, 2)
    lines = [f"mtllib {name}.mtl", "usemtl m"]
    lines += [f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in pos]
    lines += [f"vt {u:.5f} {v:.5f}" for u, v in uv]
    lines += [f"vn {x:.5f} {y:.5f} {z:.5f}" for x, y, z in pos]
    for i in range(rings):
        for j in range(segments):
            a, b = i * (segments + 1) + j + 1, (i + 1) * (segments + 1) + j + 1
            for f in ((a, b, a + 1), (a + 1, b, b + 1)):
                lines.append("f " + " ".join(f"{k}/{k}/{k}" for k in f))
    return ("\n".join(lines) + "\n").encode(), f"newmtl m\nmap_Kd {texture}\n".encode()


def small_files() -> dict:
    from PIL import Image, TiffImagePlugin

    import cv2

    h, w = SMALL
    rgb = photo(h, w, seed=1)
    rgba = np.dstack([rgb, toy_alpha(h, w)])
    grey = rgb[..., 1]
    rng = np.random.default_rng(13)
    bilevel = grey > 150
    deep = rgb.astype(np.uint16) * 257 + rng.integers(0, 256, rgb.shape).astype(np.uint16)
    TiffImagePlugin.WRITE_LIBTIFF = True
    files = {
        "tiff_rgb_raw.tif": pillow(Image.fromarray(rgb), compression="raw"),
        "tiff_rgb_lzw.tif": pillow(Image.fromarray(rgb), compression="tiff_lzw"),
        "tiff_rgb_deflate.tif": pillow(Image.fromarray(rgb), compression="tiff_adobe_deflate"),
        "tiff_rgb_packbits.tif": pillow(Image.fromarray(rgb), compression="packbits"),
        "tiff_rgba_lzw.tif": pillow(Image.fromarray(rgba), compression="tiff_lzw"),
        "tiff_grey8.tif": pillow(Image.fromarray(grey), compression="tiff_lzw"),
        "tiff_grey16.tif": pillow(Image.fromarray(deep[..., 0]), compression="tiff_lzw"),
        "tiff_grey32f.tif": pillow(Image.fromarray(rgb[..., 0].astype(np.float32) / 255),
                                   compression="tiff_adobe_deflate"),
        "tiff_grey_alpha.tif": pillow(Image.frombytes("LA", (w, h), rgba[..., [1, 3]].tobytes()),
                                      compression="tiff_lzw"),
        "tiff_palette.tif": pillow(Image.fromarray(rgb).quantize(64), compression="tiff_lzw"),
        "tiff_cmyk.tif": pillow(Image.fromarray(rgb).convert("CMYK"), compression="tiff_lzw"),
        "tiff_cielab.tif": pillow(Image.fromarray(rgb).convert("LAB")),
        "tiff_bilevel_rle.tif": pillow(Image.fromarray(bilevel), compression="tiff_ccitt"),
        "tiff_bilevel_rlew.tif": pillow(Image.fromarray(bilevel), compression="tiff_raw_16"),
        "tiff_bilevel_g3.tif": pillow(Image.fromarray(bilevel), compression="group3"),
        "tiff_bilevel_g3_2d.tif": pillow(Image.fromarray(bilevel), compression="group3",
                                         tiffinfo={292: 1}),
        "tiff_bilevel_g4.tif": pillow(Image.fromarray(bilevel), compression="group4"),
    }
    for name, img in (("tiff_rgb16.tif", deep), ("tiff_rgba16.tif",
                                                  np.dstack([deep, rgba[..., 3:].astype(np.uint16) * 257]))):
        files[name] = cv2.imencode(".tiff", np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]]),
                                   [cv2.IMWRITE_TIFF_COMPRESSION, 5])[1].tobytes()
    g4, fields = strips_of(files["tiff_bilevel_g4.tif"])
    reversed_bits = [bytes(F._REVERSED[np.frombuffer(s, np.uint8)]) for s in g4]
    jpeg_420 = F.jpeg_tiff_chunks(rgb, rows=16, quality=85, subsampling=2)
    jpeg_444 = F.jpeg_tiff_chunks(rgb, rows=16, quality=85, subsampling=0)
    jpeg_tiles = F.jpeg_tiff_chunks(rgb, tile=(32, 32), quality=85, subsampling=2)
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    idx16 = np.asarray(Image.fromarray(rgb).quantize(16))
    plte16 = np.asarray(Image.fromarray(rgb).quantize(16).getpalette()[:48]).reshape(16, 3)
    files.update({
        "tiff_rgb_lzw_pred2.tif": F.tiff(rgb, 8, 2, compression=5, predictor=2, rows_per_strip=8),
        "tiff_rgb_deflate32946_pred2.tif": F.tiff(rgb, 8, 2, compression=32946, predictor=2,
                                                  rows_per_strip=8),
        "tiff_rgb32f_pred3.tif": F.tiff(rgb.astype(np.float32) / 255 - 0.25, 32, 2,
                                        sample_format=3, compression=5, predictor=3,
                                        rows_per_strip=8),
        "tiff_jpeg_420.tif": F.tiff(rgb, 8, 6, compression=7, chunks=jpeg_420[0],
                                    rows_per_strip=16,
                                    tags={347: (7, jpeg_420[1]), 530: (3, [2, 2])}),
        "tiff_jpeg_444.tif": F.tiff(rgb, 8, 6, compression=7, chunks=jpeg_444[0],
                                    rows_per_strip=16,
                                    tags={347: (7, jpeg_444[1]), 530: (3, [1, 1])}),
        "tiff_orient3.tif": F.tiff(rgb, 8, 2, compression=5, rows_per_strip=8,
                                   tags={274: (3, 3)}),
        "tiff_orient6.tif": F.tiff(rgb, 8, 2, compression=5, rows_per_strip=8,
                                   tags={274: (3, 6)}),
        "tiff_tiled_lzw.tif": F.tiff(rgba, 8, 2, compression=5, tile=(32, 32),
                                     extra_samples=[2]),
        "tiff_tiled_jpeg.tif": F.tiff(rgb, 8, 6, compression=7, chunks=jpeg_tiles[0],
                                      tile=(32, 32),
                                      tags={347: (7, jpeg_tiles[1]), 530: (3, [2, 2])}),
        "tiff_planar.tif": F.tiff(rgba, 8, 2, compression=5, planar=2, rows_per_strip=8,
                                  extra_samples=[2]),
        "tiff_bigendian16.tif": F.tiff(deep, 16, 2, compression=5, predictor=2,
                                       rows_per_strip=8, big_endian=True),
        "tiff_bigtiff.tif": F.tiff(rgb, 8, 2, compression=8, rows_per_strip=8, bigtiff=True),
        "tiff_ycbcr_22.tif": F.tiff(ycc, 8, 6, chunks=F.ycbcr_chunks(ycc, 2, 2, 8),
                                    rows_per_strip=8,
                                    tags={530: (3, [2, 2]),
                                          532: (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])}),
        "tiff_rgba_assoc.tif": F.tiff(np.dstack([rgb.astype(np.uint16) * rgba[..., 3:] // 255,
                                                 rgba[..., 3:]]), 8, 2, compression=5,
                                      rows_per_strip=8, extra_samples=[1]),
        "tiff_palette4.tif": F.tiff(idx16, 4, 3, colormap=plte16 * 257, rows_per_strip=8),
        "tiff_two_pages.tif": F.tiff(rgb, 8, 2, compression=5, rows_per_strip=8,
                                     pages=[dict(samples=grey, bps=8, photometric=1)]),
        "tiff_g4_fill2.tif": F.tiff(bilevel, 1, fields[262][0], compression=4,
                                    chunks=reversed_bits, fill_order=2),
    })
    for bps in (1, 2, 4):
        levels = (grey.astype(np.int64) * ((1 << bps) - 1) + 127) // 255
        files[f"tiff_miniswhite{bps}.tif"] = F.tiff((1 << bps) - 1 - levels, bps, 0,
                                                    compression=5, rows_per_strip=16)
    return files


def codec_files() -> dict:
    import cv2

    from port_make_image_fixtures import hdr_photo

    h, w = SMALL
    rgb = photo(h, w, seed=1)
    grey = rgb[..., 1]
    hdr = hdr_photo(h, w, seed=1)
    bgr = np.ascontiguousarray(hdr[..., ::-1])

    def cv2_tiff(img, compression):
        return cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, compression])[1].tobytes()

    luv = cv2_tiff(bgr, 34676)
    codes = np.concatenate([_luv32_codes(s, w) for s in strips_of(luv)[0]]).reshape(h, w)
    pal = np.asarray([[(i * 37) % 256, (i * 91) % 256, (255 - i * 13) % 256] for i in range(16)])
    idx = (grey.astype(np.int64) * 15 + 127) // 255
    deep = (rgb.astype(np.int64) * 4 + np.arange(w)[None, :, None] % 4)
    files = {
        "tiff_logluv.tif": luv,
        "tiff_logluv24.tif": cv2_tiff(bgr, 34677),
        "tiff_logl.tif": cv2_tiff(np.ascontiguousarray(hdr[..., 1]), 34676),
        "tiff_logluv_tiled.tif": F.sgilog_tiff(codes, 32845, 34676, tile=(32, 32)),
        "tiff_thunderscan.tif": F.tiff(idx, 4, 3, compression=32809, colormap=pal * 257,
                                       chunks=[b"".join(F.thunder_row(r) for r in idx)]),
        "tiff_next.tif": F.tiff(grey >> 6, 2, 1, compression=32766,
                                chunks=[b"".join(F.next_row(r) for r in grey >> 6)]),
        "tiff_rgb10.tif": F.tiff(deep, 10, 2),
        "tiff_rgb12_lzw.tif": F.tiff(deep * 4, 12, 2, compression=5, rows_per_strip=16),
        "tiff_grey14_tiled.tif": F.tiff(deep[..., 1] * 16, 14, 1, tile=(32, 32)),
        "tiff_rgba12_be.tif": F.tiff(np.dstack([deep * 4, deep[..., :1] * 2]), 12, 2,
                                     extra_samples=[2], big_endian=True, rows_per_strip=8),
        "tiff_grey12_signed.tif": F.tiff(deep[..., 0] * 4, 12, 1, sample_format=2),
        "logluv_256.tif": cv2_tiff(np.ascontiguousarray(hdr_photo(256, 256, seed=3)[..., ::-1]),
                                   34676),
    }
    return files


def _luv32_codes(strip: bytes, w: int) -> np.ndarray:
    """The LogLuv32 codes of one SGILog strip of whole rows (the byte planes
    of tif_luv.c's run-length code read back), to re-code them in tiles."""
    out, at = [], 0
    while at < len(strip):
        row = np.zeros(w, np.uint64)
        for shift in (24, 16, 8, 0):
            i = 0
            while i < w:
                n = strip[at]
                if n >= 128:
                    row[i:i + n - 126] |= np.uint64(strip[at + 1]) << np.uint64(shift)
                    i, at = i + n - 126, at + 2
                else:
                    vals = np.frombuffer(strip, np.uint8, n, at + 1).astype(np.uint64)
                    row[i:i + n] |= vals << np.uint64(shift)
                    i, at = i + n, at + 1 + n
        out.append(row)
    return np.concatenate(out)


def main(argv=None) -> None:
    import cv2     # the reference; the port itself never imports it

    from port_make_image_fixtures import rgb_decode, write_set

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=("tiff", "codecs"), default="tiff")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.set == "codecs":
        out = args.out or CODECS_OUT
        os.makedirs(out, exist_ok=True)
        files = codec_files()
        write_set(cv2, files, out, {n for n in files if not n.startswith("logluv_")})
        return
    args.out = args.out or OUT
    os.makedirs(args.out, exist_ok=True)
    files = small_files()
    small = set(files)
    p512 = photo(512, 512, seed=2)
    files["photo_512_rgba.tif"] = F.tiff(np.dstack([p512, toy_alpha(512, 512)]), 8, 2,
                                         compression=5, predictor=2, rows_per_strip=16,
                                         extra_samples=[2])
    big = photo(768, 1024, seed=3)
    chunks, tables = F.jpeg_tiff_chunks(big, rows=16, quality=90, subsampling=2)
    files["photo_1024x768_jpeg.tif"] = F.tiff(big, 8, 6, compression=7, chunks=chunks,
                                              rows_per_strip=16,
                                              tags={347: (7, tables), 530: (3, [2, 2])})
    files["sphere_tiff.tif"] = F.tiff(photo(128, 128, seed=4), 8, 2, compression=5,
                                      predictor=2, tile=(64, 64))
    files["sphere_tiff.obj"], files["sphere_tiff.mtl"] = sphere_obj("sphere_tiff",
                                                                    "sphere_tiff.tif")
    digests, arrays = {}, {}
    for name, data in sorted(files.items()):
        path = os.path.join(args.out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        if name.endswith((".obj", ".mtl")):
            continue
        entry = {}
        for key, flags in (("unchanged", cv2.IMREAD_UNCHANGED), ("color", cv2.IMREAD_COLOR)):
            if cv2.imread(path, flags) is None:
                entry[key] = None
                continue
            img = rgb_decode(cv2, data, flags)
            if not np.array_equal(img, rgb_decode_file(cv2, path, flags)):
                raise RuntimeError(f"{name}: cv2.imread and cv2.imdecode differ")
            entry[key] = {"shape": list(img.shape), "dtype": str(img.dtype),
                          "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
            if name in small and key == "unchanged" and img.dtype == np.uint8:
                arrays[name] = img
        digests[name] = entry
    np.savez_compressed(os.path.join(args.out, "small_decodes.npz"), **arrays)
    with open(os.path.join(args.out, "decodes.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"[fixtures] {len(files)} files, {total} bytes in {args.out}")


def rgb_decode_file(cv2, path: str, flags: int) -> np.ndarray:
    img = cv2.imread(path, flags)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


if __name__ == "__main__":
    main()
