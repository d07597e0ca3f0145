"""Writes the fixtures of the port's image reader into
``tests/fixtures/port_images/`` (and, with ``--set hdr``, the Radiance
HDR, PFM and Sun raster set into ``tests/fixtures/port_hdr/``), with
cv2's decodes of them beside.

    python scripts/port_make_image_fixtures.py [--set images|hdr] [--out DIR]

Needs cv2 and Pillow (libwebp), which make the reference and the WebP
files: it is run where both are installed, and its files are checked in, so
that the port's checks on a machine without them (``chip_smoke.py``'s
formats phase, the card tests) still hold the port's reader against cv2.
The other formats are written by ``tests/torch_image_files.py`` from their
specifications. Writes, at 83x61 (a size no block or macroblock divides)
from the toy photo of ``scripts/port_make_jpeg_fixtures.py``:

- PNG: a palette with and without ``tRNS``, a 4-bit palette, grey at 1, 2,
  4, 8 and 16 bits, RGB with ``tRNS``, an Adam7-interlaced RGB and palette,
  16-bit RGBA, and an RGB file with an ``eXIf`` orientation of 6;
- WebP: lossless RGB and RGBA, lossy at quality 50 and 95 without and with
  alpha, lossy RGBA with a hand-made ``ALPH`` chunk under each filter
  (none, horizontal, vertical, gradient) and one stored raw, lossy at
  ``method`` 0 and 6, one rewritten to the simple loop filter and one to
  four token partitions (``vp8_rewrite``: Pillow's libwebp offers neither),
  a two-frame animation, and one with an EXIF orientation of 6;
- BMP: 1-, 4- and 8-bit palettes, a grey palette, 16-bit 5-6-5, 24-bit,
  32-bit ``BI_RGB`` and V5 ``BI_BITFIELDS`` with alpha, ``BI_RLE8`` and
  ``BI_RLE4``;
- PNM: P1-P6, a 16-bit P6, a P7 ``RGB_ALPHA`` and a P7 ``RGB``;
- GIF: one frame, one with a transparent index, an interlaced one, and a
  two-frame animation written by Pillow;
- ``photo_512_rgba.webp`` (lossy RGBA, quality 90; the toy's matte as
  alpha) and ``photo_1024x768.webp`` (lossy, quality 90);
- ``sphere_jpeg.glb``: a UV sphere (48 x 24 segments, normals, UVs) with a
  512^2 JPEG base colour, as standard exporters write it;
- ``tex_grey.obj``, ``tex_palette.obj``, ``tex_exif.obj``: one triangle
  each, with an MTL naming a grey PNG, a 4-bit palette PNG and a JPEG with
  an EXIF orientation of 6;
- ``decodes.json``: for every image (the GLB's by its embedded JPEG) the
  shape, dtype and SHA-256 of ``cv2.imread`` under ``IMREAD_UNCHANGED`` and
  ``IMREAD_COLOR``, channels in RGB order (``color`` is null for the
  4-channel PAM, whose ``IMREAD_COLOR`` decode cv2 leaves in part
  unwritten: the port refuses it); ``small_decodes.npz``: the
  83x61 files' ``IMREAD_UNCHANGED`` arrays.

The HDR set (float images from the toy photo made linear, with a bright
sun and a dim shadow so that the RGBE exponents span a wide range), each
read by ``cv2.imread`` and stored as above, null where cv2 returns None:

- Radiance HDR written by cv2, RLE and flat; the RLE file with the
  ``#?RGBE`` magic and ``EXPOSURE`` and comment lines; 7 pixels wide (flat,
  as RLE needs 8 to 32767); ``env_1024x512.hdr``, an RLE studio
  environment map (sky bands, a sun disc, a checker floor) for the decode
  time on the card; ``sphere_hdr.obj``, ``.mtl`` and ``sphere_hdr.hdr``, a
  UV sphere whose ``map_Kd`` is a 128^2 RLE HDR;
- PFM written by cv2 (colour and grey: little-endian, scale -1) and one
  big-endian colour file of scale 2;
- Sun raster written by cv2 (24-bit colour and 8-bit grey with its grey
  colormap), and from the format's description: 1-bit, 8-bit with a
  colour map, 32-bit, ``RT_OLD`` grey without a colormap (zeros under
  ``IMREAD_UNCHANGED``, as cv2 reads it) and a byte-encoded file (None).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.normpath(os.path.join(ROOT, "tests", "fixtures", "port_images"))
HDR_OUT = os.path.normpath(os.path.join(ROOT, "tests", "fixtures", "port_hdr"))
SMALL = (61, 83)            # height, width
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_image_files as F                            # noqa: E402
from port_make_jpeg_fixtures import photo                # noqa: E402


def toy_alpha(h: int, w: int) -> np.ndarray:
    """The toy's two spheres of ``photo`` as a matte with a one-pixel soft edge."""
    s = min(h, w)
    y, x = np.mgrid[0:h, 0:w] / s
    cy, cx = 0.5 * h / s, 0.5 * w / s
    inside = np.zeros((h, w))
    for oy, r in ((cy + 0.03, 0.2), (cy - 0.24, 0.1)):
        d = np.hypot(y - oy, x - cx) * s
        inside = np.maximum(inside, np.clip(r * s - d + 0.5, 0, 1))
    return (inside * 255).astype(np.uint8)


def rgb_decode(cv2, data: bytes, flags: int) -> np.ndarray:
    """cv2's decode with the channels in RGB order (as the port returns them)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    if img is None:
        raise RuntimeError("cv2 could not decode a fixture")
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def sphere_glb(texture: bytes, segments: int = 48, rings: int = 24) -> bytes:
    """A glTF 2.0 binary: one primitive (POSITION, NORMAL, TEXCOORD_0,
    indices) of a unit UV sphere and an image/jpeg base colour."""
    th = np.linspace(0, np.pi, rings + 1)
    ph = np.linspace(0, 2 * np.pi, segments + 1)
    t, p = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    uv = np.stack([p / (2 * np.pi), t / np.pi], -1).reshape(-1, 2)
    faces = []
    for i in range(rings):
        for j in range(segments):
            a, b = i * (segments + 1) + j, (i + 1) * (segments + 1) + j
            faces += [(a, b, a + 1), (a + 1, b, b + 1)]
    parts = [pos.astype(np.float32).tobytes(), pos.astype(np.float32).tobytes(),
             uv.astype(np.float32).tobytes(), np.asarray(faces, np.uint32).tobytes(), texture]
    views, blob = [], b""
    for part in parts:
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(part)})
        blob += part + b"\0" * (-len(part) % 4)
    n = len(pos)
    acc = [{"bufferView": 0, "componentType": 5126, "count": n, "type": "VEC3",
            "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
           {"bufferView": 1, "componentType": 5126, "count": n, "type": "VEC3"},
           {"bufferView": 2, "componentType": 5126, "count": n, "type": "VEC2"},
           {"bufferView": 3, "componentType": 5125, "count": 3 * len(faces), "type": "SCALAR"}]
    gltf = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(blob)}],
            "bufferViews": views, "accessors": acc,
            "images": [{"bufferView": 4, "mimeType": "image/jpeg"}],
            "textures": [{"source": 0}],
            "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                       "TEXCOORD_0": 2},
                                        "indices": 3, "material": 0}]}],
            "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}], "scene": 0}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    body = struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob), 0x004E4942) + blob
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def triangle_obj(name: str, texture: str) -> tuple[bytes, bytes]:
    obj = (f"mtllib {name}.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
           "f 1/1 2/2 3/3\n")
    return obj.encode(), f"newmtl m\nmap_Kd {texture}\n".encode()


def small_files(cv2) -> dict:
    h, w = SMALL
    rgb = photo(h, w, seed=1)
    rgba = np.dstack([rgb, toy_alpha(h, w)])
    grey = rgb[..., 1]
    rng = np.random.default_rng(12)
    from PIL import Image

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    pal_img = Image.fromarray(rgb).quantize(64)
    idx = np.asarray(pal_img)
    plte = np.asarray(pal_img.getpalette()[:64 * 3], np.uint8).reshape(64, 3)
    idx16 = np.asarray(Image.fromarray(rgb).quantize(16))
    plte16 = np.asarray(Image.fromarray(rgb).quantize(16).getpalette()[:48], np.uint8).reshape(16, 3)
    trns = bytes(np.where(np.arange(64) % 5 == 0, 0, 255).astype(np.uint8))
    deep = rgb.astype(np.uint16) * 257 + rng.integers(0, 256, rgb.shape).astype(np.uint16)
    files = {
        "png_palette.png": F.png(idx[..., None], 8, 3, plte, seed=1),
        "png_palette_trns.png": F.png(idx[..., None], 8, 3, plte, trns=trns, seed=2),
        "png_palette4.png": F.png(idx16[..., None], 4, 3, plte16, seed=3),
        "png_palette_adam7.png": F.png(idx[..., None], 8, 3, plte, interlace=True, seed=4),
        **{f"png_grey{d}.png": F.png((grey.astype(np.int64) * ((1 << d) - 1) // 255)[..., None]
                                     if d < 16 else deep[..., :1], d, 0, seed=d)
           for d in (1, 2, 4, 8, 16)},
        "png_rgb_trns.png": F.png(rgb, 8, 2, trns=struct.pack(">3H", *map(int, rgb[0, 0])), seed=5),
        "png_adam7.png": F.png(rgb, 8, 2, interlace=True, seed=6),
        "png_rgba16.png": F.png(np.dstack([deep, rgba[..., 3:].astype(np.uint16) * 257]), 16, 6,
                                seed=7),
        "png_exif6.png": F.png(rgb, 8, 2, exif=F.exif_orientation(6), seed=8),
        "webp_lossless.webp": F.webp(rgb, lossless=True),
        "webp_lossless_alpha.webp": F.webp(rgba, lossless=True),
        "webp_q50.webp": F.webp(rgb, quality=50),
        "webp_q95.webp": F.webp(rgb, quality=95),
        "webp_q50_alpha.webp": F.webp(rgba, quality=50),
        "webp_q95_alpha.webp": F.webp(rgba, quality=95),
        **{f"webp_alpha_filter{m}.webp": F.webp_with_alph(rgba, m, compressed=True)
           for m in range(4)},
        "webp_alpha_raw.webp": F.webp_with_alph(rgba, 3, compressed=False),
        "webp_simple_filter.webp": F.vp8_rewrite(F.webp(rgb, quality=80), simple=1, level=30,
                                                 sharpness=2),
        "webp_partitions4.webp": F.vp8_rewrite(F.webp(rgb, quality=80), partitions=4, level=40,
                                               sharpness=5),
        "webp_method0.webp": F.webp(rgb, quality=80, method=0),
        "webp_method6.webp": F.webp(rgb, quality=80, method=6),
        "webp_animated.webp": pil(Image.fromarray(rgba), "WEBP", save_all=True, quality=80,
                                  append_images=[Image.fromarray(rgba[::-1].copy())]),
        "webp_exif6.webp": F.webp_with_exif(F.webp(rgb, quality=80), F.exif_orientation(6)),
        "bmp_1.bmp": F.bmp((grey > 128).astype(np.uint8), 1, [(20, 40, 200), (250, 240, 10)]),
        "bmp_4.bmp": F.bmp(idx16, 4, plte16),
        "bmp_8.bmp": F.bmp(idx, 8, plte),
        "bmp_8_grey.bmp": F.bmp(grey, 8, np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)),
        "bmp_16.bmp": F.bmp(((rgb[..., 0].astype(np.uint16) >> 3) << 11
                             | (rgb[..., 1].astype(np.uint16) >> 2) << 5
                             | rgb[..., 2].astype(np.uint16) >> 3), 16, compression=3,
                            masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_24.bmp": F.bmp(rgb, 24),
        "bmp_32.bmp": F.bmp(rgb, 32),
        "bmp_32_v5.bmp": F.bmp(rgba, 32, header=124, compression=3,
                               masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "bmp_rle8.bmp": F.bmp(idx, 8, plte, compression=1),
        "bmp_rle4.bmp": F.bmp(idx16, 4, plte16, compression=2, eol_early=True),
        "pnm_p1.pbm": F.pnm((grey < 128).astype(np.uint8), 1),
        "pnm_p2.pgm": F.pnm(grey.astype(np.int64) * 1000 // 255, 2, 1000, comment=True),
        "pnm_p3.ppm": F.pnm(rgb.astype(np.int64) * 100 // 255, 3, 100),
        "pnm_p4.pbm": F.pnm((grey < 128).astype(np.uint8), 4),
        "pnm_p5.pgm": F.pnm(grey, 5),
        "pnm_p6.ppm": F.pnm(rgb, 6),
        "pnm_p6_16.ppm": F.pnm(deep, 6, 65535),
        "pnm_p7.pam": F.pam(rgba, "RGB_ALPHA"),
        "pnm_p7_rgb.pam": F.pam(rgb, "RGB"),
        "gif_single.gif": F.gif(w, h, [dict(idx=idx)], plte),
        "gif_transparent.gif": F.gif(w, h, [dict(idx=idx, transparent=int(idx[0, 0]))], plte, bg=3),
        "gif_interlaced.gif": F.gif(w, h, [dict(idx=idx16, interlace=True)], plte16),
        "gif_two_frames.gif": pil(pal_img, "GIF", save_all=True,
                                  append_images=[Image.fromarray(rgb[::-1].copy()).quantize(64)]),
    }
    jpeg = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
    files["tex_grey.png"] = F.png(grey[..., None], 8, 0, seed=9)
    files["tex_palette.png"] = files["png_palette4.png"]
    files["tex_exif.jpg"] = F.jpeg_with_exif(jpeg.tobytes(), F.exif_orientation(6))
    return files


def hdr_photo(h: int, w: int, seed: int) -> np.ndarray:
    """float32 [h, w, 3] RGB: the toy photo made linear (gamma 2.2), its top
    right corner a sun 40 times brighter, its bottom left a shadow at 1/50."""
    img = (photo(h, w, seed) / 255.0) ** 2.2
    yy, xx = np.mgrid[0:h, 0:w]
    img[(yy < h // 4) & (xx > 3 * w // 4)] *= 40
    img[(yy > 3 * h // 4) & (xx < w // 4)] /= 50
    return img.astype(np.float32)


def env_map(h: int, w: int) -> np.ndarray:
    """float32 [h, w, 3]: a studio environment map, equirectangular: a sky in
    bands of 1/16, a sun disc of 1000, a checker floor of 32-pixel squares."""
    y = (np.arange(h) + 0.5) / h
    sky = np.round(np.stack([0.3 + 0.5 * y, 0.5 + 0.4 * y, 0.9 - 0.2 * y], -1) * 16) / 16
    img = np.repeat(sky[:, None], w, axis=1)
    yy, xx = np.mgrid[0:h, 0:w]
    floor = yy >= h // 2
    img[floor] = np.where((((yy // 32) + (xx // 32)) % 2 == 0)[floor][:, None], 0.6, 0.2)
    sun = (yy - h // 4) ** 2 + (xx - 7 * w // 10) ** 2 < (h // 32) ** 2
    img[sun] = (1000.0, 950.0, 800.0)
    return img.astype(np.float32)


def hdr_files(cv2) -> dict:
    h, w = SMALL
    rgb = hdr_photo(h, w, seed=1)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    rle = cv2.imencode(".hdr", bgr)[1].tobytes()
    flat = cv2.imencode(".hdr", bgr, [cv2.IMWRITE_HDR_COMPRESSION,
                                      cv2.IMWRITE_HDR_COMPRESSION_NONE])[1].tobytes()
    head = rle.index(b"\n-Y") + 1
    rgbe = (b"#?RGBE\n# written from the toy photo\nEXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n"
            + rle[head:])
    toy = photo(h, w, seed=1)
    grey = toy[..., 1]
    rng = np.random.default_rng(19)
    cmap = rng.integers(0, 256, 3 * 256, dtype=np.uint8).tobytes()
    bits = np.packbits(grey > 128, axis=1)
    xbgr = np.dstack([np.zeros((h, w), np.uint8), toy[..., ::-1]]).reshape(h, -1)
    files = {
        "hdr_rle.hdr": rle,
        "hdr_flat.hdr": flat,
        "hdr_rgbe_magic.hdr": rgbe,
        "hdr_narrow.hdr": cv2.imencode(".hdr", np.ascontiguousarray(bgr[:, :7]))[1].tobytes(),
        "pfm_rgb.pfm": cv2.imencode(".pfm", bgr)[1].tobytes(),
        "pfm_grey.pfm": cv2.imencode(".pfm", np.ascontiguousarray(rgb[..., 1]))[1].tobytes(),
        "pfm_rgb_be.pfm": (f"PF\n{w} {h}\n2\n".encode()
                           + (rgb[::-1] * 2).astype(">f4").tobytes()),
        "ras_rgb.ras": cv2.imencode(".ras", np.ascontiguousarray(toy[..., ::-1]))[1].tobytes(),
        "ras_grey.ras": cv2.imencode(".ras", grey)[1].tobytes(),
        "ras_1bit.ras": F.sunras(w, h, 1, 1, bits),
        "ras_colormap.ras": F.sunras(w, h, 8, 1, grey // 4, cmap),
        "ras_32bit.ras": F.sunras(w, h, 32, 1, xbgr),
        "ras_old_grey.ras": F.sunras(w, h, 8, 0, grey),
    }
    rows = np.pad(grey, ((0, 0), (0, w & 1))).tobytes()
    files["ras_byte_encoded.ras"] = (struct.pack(">8I", 0x59A66A95, w, h, 8, len(rows), 2, 0, 0)
                                     + F.sunras_rle(rows))
    files["env_1024x512.hdr"] = cv2.imencode(".hdr", np.ascontiguousarray(
        env_map(512, 1024)[..., ::-1]))[1].tobytes()
    files["sphere_hdr.hdr"] = cv2.imencode(".hdr", np.ascontiguousarray(
        hdr_photo(128, 128, seed=4)[..., ::-1]))[1].tobytes()
    from port_make_tiff_fixtures import sphere_obj

    files["sphere_hdr.obj"], files["sphere_hdr.mtl"] = sphere_obj("sphere_hdr", "sphere_hdr.hdr")
    return files


def write_set(cv2, files: dict, out: str, small: set) -> None:
    """Every file written to ``out``, with ``decodes.json`` (cv2.imread's
    shape, dtype and SHA-256 under both flags, channels in RGB order; null
    where it is None) and ``small_decodes.npz`` (the ``small`` files'
    IMREAD_UNCHANGED arrays)."""
    digests, arrays = {}, {}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        if name.endswith((".obj", ".mtl")):
            continue
        entry = {}
        for key, flags in (("unchanged", cv2.IMREAD_UNCHANGED), ("color", cv2.IMREAD_COLOR)):
            img = cv2.imread(path, flags)
            if img is None:
                entry[key] = None
                continue
            if img.ndim == 3 and img.shape[2] in (3, 4):
                img = img[..., [2, 1, 0, 3][:img.shape[2]]]
            img = np.ascontiguousarray(img)
            entry[key] = {"shape": list(img.shape), "dtype": str(img.dtype),
                          "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
            if name in small and key == "unchanged":
                arrays[name] = img
        digests[name] = entry
    np.savez_compressed(os.path.join(out, "small_decodes.npz"), **arrays)
    with open(os.path.join(out, "decodes.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"[fixtures] {len(files)} files, {total} bytes in {out}")


def main(argv=None) -> None:
    import cv2     # the reference; the port itself never imports it

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=("images", "hdr"), default="images")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.set == "hdr":
        out = args.out or HDR_OUT
        os.makedirs(out, exist_ok=True)
        files = hdr_files(cv2)
        write_set(cv2, files, out, {n for n in files if not n.startswith(("env_", "sphere_"))})
        return
    args.out = args.out or OUT
    os.makedirs(args.out, exist_ok=True)
    files = small_files(cv2)
    small = set(files)
    p512 = photo(512, 512, seed=2)
    files["photo_512_rgba.webp"] = F.webp(np.dstack([p512, toy_alpha(512, 512)]), quality=90)
    files["photo_1024x768.webp"] = F.webp(photo(768, 1024, seed=3), quality=90)
    texture = cv2.imencode(".jpg", np.ascontiguousarray(photo(512, 512, seed=4)[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes()
    files["sphere_jpeg.glb"] = sphere_glb(texture)
    for name, tex in (("tex_grey", "tex_grey.png"), ("tex_palette", "tex_palette.png"),
                      ("tex_exif", "tex_exif.jpg")):
        files[f"{name}.obj"], files[f"{name}.mtl"] = triangle_obj(name, tex)
    digests, arrays = {}, {}
    for name, data in sorted(files.items()):
        with open(os.path.join(args.out, name), "wb") as fh:
            fh.write(data)
        if name.endswith((".obj", ".mtl")):
            continue
        image = texture if name.endswith(".glb") else data
        entry = {}
        for key, flags in (("unchanged", cv2.IMREAD_UNCHANGED), ("color", cv2.IMREAD_COLOR)):
            if name == "pnm_p7.pam" and key == "color":
                entry[key] = None
                continue
            img = rgb_decode(cv2, image, flags)
            entry[key] = {"shape": list(img.shape), "dtype": str(img.dtype),
                          "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
            if name in small and key == "unchanged":
                arrays[name] = img
        digests[name] = entry
    np.savez_compressed(os.path.join(args.out, "small_decodes.npz"), **arrays)
    with open(os.path.join(args.out, "decodes.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"[fixtures] {len(files)} files, {total} bytes in {args.out}")


if __name__ == "__main__":
    main()
