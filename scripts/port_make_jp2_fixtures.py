"""Writes the JPEG 2000 fixtures of the port's reader into
``tests/fixtures/port_jp2/`` and ``tests/fixtures/port_jp2_archival/``,
with cv2's decodes of them beside.

    python scripts/port_make_jp2_fixtures.py [--out tests/fixtures/port_jp2]
        [--archival-out tests/fixtures/port_jp2_archival]

Needs cv2 (OpenCV 5.0 over OpenJPEG 2.5), which makes the reference, and
Pillow (its OpenJPEG encoder), which writes the codestreams: it is run where
both are installed, and its files are checked in, so that the port's checks
on a machine without them (``chip_smoke.py``'s formats phase, the card
tests) still hold the port's reader against cv2. At 83x61 from the toy photo
of ``scripts/port_make_jpeg_fixtures.py``:

- written by Pillow: L, LA, RGB, RGBA and I;16, each lossless (5/3) and
  irreversible (9/7); RGB with the multiple-component transform (RCT and
  ICT) and quality layers; each of the five progression orders with 1 to 6
  resolutions, 1 to 3 layers and precincts; code-blocks of 16^2 and 64^2;
  tiles of 32^2, and of 32^2 with an image and tile offset (cv2 reads no
  image origin but 0: its decode is null); PLT markers; a comment; a raw
  ``.j2k`` codestream; signed components (null); 64^2 and 96x64
  digital-cinema 2K and 4K profiles (the 4K one with a POC marker);
- rewritten by ``tests/torch_image_files.py``: ``colr`` as greyscale, sYCC,
  CMYK (null), an unknown enumeration and an ICC profile; ``cdef`` boxes
  that move the alpha channel and the colours; a palette (``pclr`` and
  ``cmap``) over an 8-bit index codestream; SIZ precisions of 12 and 20
  bits; every tile over two tile-parts with a TLM marker; COC and QCC
  markers in the main and in the tile-part headers; the 4K profile's POC
  moved into the tile-part headers; an SOP marker before every packet;
- ``photo_1024x768_lossy.jp2``: 9/7 with the ICT in three quality layers
  (236 KB), and ``photo_1024x768_lossless.jp2``: 5/3 with the RCT (1.2 MB),
  the host's decode time at a photo's size; ``photo_512_rgba.jp2``: the
  toy photo with its matte, lossless (a cut-out as image editors export
  it);
- ``sphere_jp2.obj``, ``.mtl`` and ``sphere_jp2.jp2``: a UV sphere (32 x
  16 segments) whose ``map_Kd`` is a 128^2 RGB JP2 in 32^2 tiles;
- ``decodes.json``: for every image the shape, dtype and SHA-256 of
  ``cv2.imread`` under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``, channels
  in RGB order, or null where cv2 returns None; ``small_decodes.npz``: the
  83x61 files' 8-bit ``IMREAD_UNCHANGED`` arrays.

The archival set (``--archival-out``, its own ``decodes.json`` and
``small_decodes.npz``) is written by OpenJPEG's own encoder through
``tests/torch_image_files.py`` ``jp2_openjpeg`` (the library Pillow
bundles), with the coding options archives and fast encoders turn on:

- at 83x61: EPH markers, with and without SOP; each code-block style alone
  (BYPASS, RESET, RESTART, CAUSAL, ERTERM, SEGMARK), the error-resilient
  five together and all six (``opj_compress -M 63``); BYPASS on grey; ROI
  (RGN) in the main header, in the tile-part headers, and with a shift
  past 30 bit-planes (null); packed packet headers in PPM markers and in
  PPT markers, and a raw codestream with BYPASS, PPT and RGN;
- ``photo_512_rgba_archival.jp2``: the 512^2 cut-out lossless (5/3, RCT)
  with SOP, EPH and RESET|RESTART|CAUSAL|ERTERM|SEGMARK;
  ``photo_1024x768_bypass.jp2``: the 1024x768 photo with the 9/7 and the
  ICT in three layers as ``photo_1024x768_lossy.jp2``, BYPASS-coded, the
  host's decode time;
- ``sphere_jp2_archival.obj``, ``.mtl`` and ``.jp2``: the UV sphere with a
  128^2 RGB texture in 32^2 tiles, BYPASS-coded, its packet headers in PPT
  markers and an RGN marker on component 0 (OpenJPEG's encoder writes the
  marker and codes the data unshifted, and its decoder takes BYPASS's raw
  passes of that component for MQ-coded ones: cv2's decode has noise in
  the red channel's low bits, and the port's equals it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.normpath(os.path.join(ROOT, "tests", "fixtures", "port_jp2"))
ARCHIVAL_OUT = os.path.normpath(os.path.join(ROOT, "tests", "fixtures", "port_jp2_archival"))
SMALL = (61, 83)            # height, width
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_image_files as F                            # noqa: E402
from port_make_image_fixtures import toy_alpha           # noqa: E402
from port_make_jpeg_fixtures import photo                # noqa: E402
from port_make_tiff_fixtures import rgb_decode_file, sphere_obj  # noqa: E402

MODES = {"bypass": 1, "reset": 2, "restart": 4, "causal": 8, "erterm": 16, "segmark": 32}
ORDERS = {"LRCP": (1, 1), "RLCP": (3, 2), "RPCL": (6, 3), "PCRL": (4, 3), "CPRL": (5, 2)}


def small_files() -> dict:
    h, w = SMALL
    rgb = photo(h, w, seed=1)
    rgba = np.dstack([rgb, toy_alpha(h, w)])
    rng = np.random.default_rng(17)
    deep = rgb[..., 1].astype(np.uint16) * 257 + rng.integers(0, 256, (h, w)).astype(np.uint16)
    lossy = dict(irreversible=True)
    layers = dict(quality_mode="rates", quality_layers=[30, 12, 4])
    files = {}
    for name, img, mode in (("l", rgb, "L"), ("la", rgba, "LA"), ("rgb", rgb, None),
                            ("rgba", rgba, None), ("i16", deep, None)):
        files[f"jp2_{name}_53.jp2"] = F.jp2_pillow(img, mode=mode)
        files[f"jp2_{name}_97.jp2"] = F.jp2_pillow(img, mode=mode, **lossy)
    files.update({
        "jp2_rgb_rct.jp2": F.jp2_pillow(rgb, mct=1),
        "jp2_rgb_ict_layers.jp2": F.jp2_pillow(rgb, mct=1, **lossy, **layers),
        "jp2_rgb_53_layers.jp2": F.jp2_pillow(rgb, quality_mode="rates", quality_layers=[20, 5]),
        "jp2_cblk16.jp2": F.jp2_pillow(rgb, codeblock_size=(16, 16), mct=1, **lossy),
        "jp2_cblk64.jp2": F.jp2_pillow(rgb, codeblock_size=(64, 64), num_resolutions=3),
        "jp2_precincts.jp2": F.jp2_pillow(rgb, precinct_size=(32, 32), codeblock_size=(16, 16)),
        "jp2_tiles32.jp2": F.jp2_pillow(rgba, tile_size=(32, 32), num_resolutions=6, **lossy),
        "jp2_tiles32_offset.jp2": F.jp2_pillow(rgb, tile_size=(32, 32), offset=(5, 3),
                                               tile_offset=(2, 1)),
        "jp2_plt.jp2": F.jp2_pillow(rgb, plt=True, mct=1),
        "jp2_comment.jp2": F.jp2_pillow(rgb, comment="a comment segment", mct=1),
        "jp2_raw.j2k": F.jp2_pillow(rgb, no_jp2=True, mct=1, **lossy),
        "jp2_signed.jp2": F.jp2_pillow(rgb, mode="L", signed=True),
        "jp2_cinema2k.jp2": F.jp2_pillow(photo(64, 64, seed=5), cinema_mode="cinema2k-24"),
        "jp2_cinema4k_poc.jp2": F.jp2_pillow(photo(64, 96, seed=6), cinema_mode="cinema4k-24"),
    })
    c4k = files["jp2_cinema4k_poc.jp2"]
    files["jp2_poc_in_tiles.jp2"] = F.jp2_rebuild(
        c4k, codestream=F.j2k_poc_in_tiles(F.jp2_codestream(c4k)))
    with_plt = F.jp2_pillow(rgb, plt=True, mct=1, tile_size=(48, 32), num_resolutions=4,
                            progression="PCRL", **layers)
    files["jp2_sop.jp2"] = F.jp2_rebuild(
        with_plt, codestream=F.j2k_with_sop(F.jp2_codestream(with_plt)))
    for order, (res, nl) in ORDERS.items():
        files[f"jp2_order_{order.lower()}.jp2"] = F.jp2_pillow(
            rgb, progression=order, num_resolutions=res,
            precinct_size=(32, 32) if res > 2 else None, quality_mode="rates",
            quality_layers=[30, 12, 4][3 - nl:], tile_size=(48, 32) if res == 4 else None, mct=1)
    base, base4 = files["jp2_rgb_rct.jp2"], files["jp2_rgba_53.jp2"]
    for name, enumcs in (("grey", 17), ("sycc", 18), ("cmyk", 12), ("unknown", 99)):
        files[f"jp2_colr_{name}.jp2"] = F.jp2_rebuild(base, F.jp2_header_with(F.jp2_colr(enumcs)))
    files["jp2_colr_icc.jp2"] = F.jp2_rebuild(base, F.jp2_header_with(F.jp2_colr(icc=bytes(132))))
    files["jp2_rgba_sycc.jp2"] = F.jp2_rebuild(base4, F.jp2_header_with(F.jp2_colr(18)))
    for name, entries in (("alpha_first", [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]),
                          ("bgr", [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 2, 0)])):
        files[f"jp2_cdef_{name}.jp2"] = F.jp2_rebuild(
            base4, F.jp2_header_with(drop=(b"cdef",), extra=[(b"cdef", F.jp2_cdef(entries))]))
    index = (rgb[..., 1] // 8).astype(np.uint8)
    palette = rng.integers(0, 256, (32, 3))
    pal = [(b"pclr", F.jp2_pclr(palette, [8, 8, 8])),
           (b"cmap", F.jp2_cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)]))]
    files["jp2_palette.jp2"] = F.jp2_rebuild(F.jp2_pillow(index),
                                             F.jp2_header_with(F.jp2_colr(16), extra=pal))
    i16 = files["jp2_i16_53.jp2"]
    for prec in (12, 20):
        files[f"jp2_prec{prec}.jp2"] = F.jp2_rebuild(
            i16, codestream=F.j2k_set_precision(F.jp2_codestream(i16), [prec]))
    tiled = F.jp2_pillow(rgb, tile_size=(32, 32), plt=True, num_resolutions=3, mct=1)
    files["jp2_tile_parts_tlm.jp2"] = F.jp2_rebuild(
        tiled, codestream=F.j2k_split_tile_parts(F.jp2_codestream(tiled), tlm=True))
    for where in ("main", "tile"):
        files[f"jp2_coc_qcc_{where}.jp2"] = F.jp2_rebuild(
            tiled, codestream=F.j2k_per_component_markers(F.jp2_codestream(tiled), where))
    return files


def archival_small_files() -> dict:
    h, w = SMALL
    rgb = photo(h, w, seed=1)
    rgba = np.dstack([rgb, toy_alpha(h, w)])
    lossy = dict(irreversible=True, rates=(20, 5))
    files = {
        "jp2_eph.jp2": F.jp2_openjpeg(rgb, csty=4),
        "jp2_sop_eph_layers.jp2": F.jp2_openjpeg(rgba, csty=6, irreversible=True,
                                                 rates=(30, 12, 4)),
        "jp2_mode_archival.jp2": F.jp2_openjpeg(rgb, csty=6, mode=62),
        "jp2_mode_all.jp2": F.jp2_openjpeg(rgba, mode=63, tile=(32, 32), rates=(20, 5)),
        "jp2_mode_bypass_grey.jp2": F.jp2_openjpeg(rgb[..., 1], mode=1),
        "jp2_rgn_main.jp2": F.jp2_openjpeg(rgb, roi=(0, 6), **lossy),
    }
    for name, mode in MODES.items():
        files[f"jp2_mode_{name}.jp2"] = F.jp2_openjpeg(rgb, mode=mode, **lossy)
    tiled = F.jp2_openjpeg(rgba, tile=(32, 32), rates=(20, 5))
    files["jp2_rgn_tiles.jp2"] = F.jp2_rebuild(
        tiled, codestream=F.j2k_rgn(F.jp2_codestream(tiled), 3, 9, "tile"))
    files["jp2_rgn_past.jp2"] = F.jp2_rebuild(
        tiled, codestream=F.j2k_rgn(F.jp2_codestream(tiled), 0, 40))
    marked = F.jp2_openjpeg(rgb, csty=6, tile=(32, 32), rates=(20, 5))
    files["jp2_ppm.jp2"] = F.jp2_rebuild(
        marked, codestream=F.j2k_packed_headers(F.jp2_codestream(marked), "ppm", chunk=200))
    marked = F.jp2_openjpeg(rgba, csty=6, irreversible=True, rates=(30, 12, 4))
    files["jp2_ppt.jp2"] = F.jp2_rebuild(marked, codestream=F.j2k_packed_headers(
        F.jp2_codestream(marked), "ppt", eph=False, sop=False))
    files["jp2_ppt_bypass_rgn.j2k"] = F.j2k_packed_headers(
        F.jp2_openjpeg(rgb, csty=6, mode=1, roi=(0, 3), jp2=False, **lossy), "ppt", sop=False)
    return files



def archival_files() -> tuple[dict, set]:
    files = archival_small_files()
    small = set(files)
    p512 = np.dstack([photo(512, 512, seed=2), toy_alpha(512, 512)])
    files["photo_512_rgba_archival.jp2"] = F.jp2_openjpeg(p512, csty=6, mode=62)
    files["photo_1024x768_bypass.jp2"] = F.jp2_openjpeg(
        photo(768, 1024, seed=3), mode=1, irreversible=True, rates=(40, 20, 10))
    tex = F.jp2_openjpeg(photo(128, 128, seed=4), csty=6, mode=1, roi=(0, 4), tile=(32, 32),
                         mct=0)
    files["sphere_jp2_archival.jp2"] = F.jp2_rebuild(
        tex, codestream=F.j2k_packed_headers(F.jp2_codestream(tex), "ppt", sop=False))
    files["sphere_jp2_archival.obj"], files["sphere_jp2_archival.mtl"] = sphere_obj(
        "sphere_jp2_archival", "sphere_jp2_archival.jp2")
    return files, small


def base_files() -> tuple[dict, set]:
    files = small_files()
    small = set(files)
    p512 = photo(512, 512, seed=2)
    files["photo_512_rgba.jp2"] = F.jp2_pillow(np.dstack([p512, toy_alpha(512, 512)]))
    big = photo(768, 1024, seed=3)
    files["photo_1024x768_lossy.jp2"] = F.jp2_pillow(big, irreversible=True, mct=1,
                                                     quality_mode="rates",
                                                     quality_layers=[40, 20, 10])
    files["photo_1024x768_lossless.jp2"] = F.jp2_pillow(big, mct=1)
    files["sphere_jp2.jp2"] = F.jp2_pillow(photo(128, 128, seed=4), tile_size=(32, 32), mct=1)
    files["sphere_jp2.obj"], files["sphere_jp2.mtl"] = sphere_obj("sphere_jp2", "sphere_jp2.jp2")
    return files, small


def write_set(cv2, out: str, files: dict, small: set) -> None:
    """The files, their cv2 decodes' digests and the small ones' arrays."""
    from port_make_image_fixtures import rgb_decode

    os.makedirs(out, exist_ok=True)
    digests, arrays = {}, {}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
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
    np.savez_compressed(os.path.join(out, "small_decodes.npz"), **arrays)
    with open(os.path.join(out, "decodes.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"[fixtures] {len(files)} files, {total} bytes in {out}")


def main(argv=None) -> None:
    import cv2     # the reference; the port itself never imports it

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--archival-out", default=ARCHIVAL_OUT)
    args = ap.parse_args(argv)
    write_set(cv2, args.out, *base_files())
    write_set(cv2, args.archival_out, *archival_files())


if __name__ == "__main__":
    main()
