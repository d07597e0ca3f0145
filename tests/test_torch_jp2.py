"""The port's JPEG 2000 reader (``utils/jpeg2000.py`` over
``csrc/jpeg2000.cpp``) against cv2 (OpenCV 5.0 over OpenJPEG 2.5), and what
reads through it against the JAX package: ``load_rgba`` and the textures of
``Mesh.load``.

Tolerance: every decode equal to cv2's bit for bit (dtype, shape, values;
channels in RGB order) under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``, on
the checked-in fixtures of ``scripts/port_make_jp2_fixtures.py`` (and their
stored digests) and on files written here from numpy seeds by Pillow's
OpenJPEG encoder, by OpenJPEG's own encoder called through ``ctypes`` (the
coding options Pillow does not pass on: SOP/EPH markers, the six
code-block styles, ROI) and rewritten by ``tests/torch_image_files.py``
(RGN markers moved, packet headers packed into PPM/PPT markers); where
cv2 returns None the port raises ValueError naming JPEG 2000, and the
features it does not decode (HTJ2K, Part 2) raise NotImplementedError
naming them. ``load_rgba`` of
a 4-channel JP2 equal to the JAX package's exactly, of an RGB one matted by
the same random U2Net at ``test_torch_image_formats.py``'s tolerances (RGB
equal, alpha within 1/255); ``Mesh.load`` albedos equal exactly."""

import hashlib
import json
import struct

import cv2
import numpy as np
import pytest

import torch_image_files as F
from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu.meshing.mesh import Mesh as JMesh
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.meshing.mesh import Mesh as TMesh
from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, IMREAD_UNCHANGED, decode_image
from test_torch_image_formats import _glb_with_image, u2net_at_64  # noqa: F401
from test_torch_process import u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import JP2_ARCHIVAL_FIXTURES, JP2_FIXTURES

DIGESTS = json.loads((JP2_FIXTURES / "decodes.json").read_text())
IMAGES = sorted(DIGESTS)
ARCHIVAL_DIGESTS = json.loads((JP2_ARCHIVAL_FIXTURES / "decodes.json").read_text())
FLAGS = {"unchanged": IMREAD_UNCHANGED, "color": IMREAD_COLOR}
IMG = F.photo(45, 70, 3)
RGBA = F.photo(45, 70, 4, channels=4)


def _rgb(img):
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def _same_as_cv2(data: bytes, path=None, none=None):
    """Both flags: the port's decode equals cv2.imdecode's (with ``path``,
    also read_image against cv2.imread of that file), or both give none.
    ``none`` (a tuple of flags) asserts where cv2 gives none."""
    for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
        cases = [(_rgb(cv2.imdecode(np.frombuffer(data, np.uint8), f)),
                  lambda: decode_image(data, f))]
        if path is not None:
            path.write_bytes(data)
            cases.append((_rgb(cv2.imread(str(path), f)), lambda: tproc.read_image(str(path), f)))
        for want, read in cases:
            if none is not None:
                assert (want is None) == (f in none), f
            if want is None:
                with pytest.raises(ValueError, match="JPEG 2000"):
                    read()
                continue
            got = read()
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fixtures

def _fixture_as_cv2_read_it(folder, digests, name, key):
    path = folder / name
    want = digests[name][key]
    live = _rgb(cv2.imread(str(path), FLAGS[key]))
    if want is None:
        assert live is None
        with pytest.raises(ValueError, match="JPEG 2000"):
            tproc.read_image(str(path), FLAGS[key])
        return
    got = tproc.read_image(str(path), FLAGS[key])
    assert [list(got.shape), str(got.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, live)
    if key == "unchanged":
        with np.load(folder / "small_decodes.npz") as small:
            if name in small.files:
                np.testing.assert_array_equal(got, small[name])


@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", IMAGES)
def test_fixture_reads_as_cv2_read_it(name, key):
    _fixture_as_cv2_read_it(JP2_FIXTURES, DIGESTS, name, key)


@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", sorted(ARCHIVAL_DIGESTS))
def test_archival_fixture_reads_as_cv2_read_it(name, key):
    """The fixtures OpenJPEG's own encoder wrote: SOP/EPH, the code-block
    styles, ROI, packed packet headers (``tests/fixtures/port_jp2_archival/``)."""
    _fixture_as_cv2_read_it(JP2_ARCHIVAL_FIXTURES, ARCHIVAL_DIGESTS, name, key)


def test_fixture_directory_stays_small():
    assert sum(f.stat().st_size for f in JP2_FIXTURES.iterdir()) < 3 * 2**20


def test_archival_fixture_directory_stays_small():
    assert sum(f.stat().st_size for f in JP2_ARCHIVAL_FIXTURES.iterdir()) < 3 * 2**20


def test_the_archival_fixtures_carry_what_they_are_named_for():
    """Each archival fixture's codestream holds the markers and flags its
    name says, as the library wrote them (so the cases above cover them)."""
    def main_of(name):
        data = (JP2_ARCHIVAL_FIXTURES / name).read_bytes()
        cs = data if name.endswith(".j2k") else F.jp2_codestream(data)
        return F.j2k_parse(cs)

    def cod(name):
        return dict(main_of(name)[0])[0xFF52]

    assert cod("jp2_eph.jp2")[0] == 4 and cod("jp2_sop_eph_layers.jp2")[0] == 6
    for name, style in (("bypass", 1), ("reset", 2), ("restart", 4), ("causal", 8),
                        ("erterm", 16), ("segmark", 32), ("archival", 62), ("all", 63),
                        ("bypass_grey", 1)):
        assert cod(f"jp2_mode_{name}.jp2")[8] == style, name
    assert (cod("photo_512_rgba_archival.jp2")[0], cod("photo_512_rgba_archival.jp2")[8]) == (6, 62)
    assert cod("photo_1024x768_bypass.jp2")[8] == 1
    assert dict(main_of("jp2_rgn_main.jp2")[0])[0xFF5E] == bytes([0, 0, 6])
    main, parts = main_of("jp2_rgn_tiles.jp2")
    assert 0xFF5E not in dict(main) and all((0xFF5E, bytes([3, 0, 9])) in segs
                                            for _, tp, _, segs, _ in parts if tp == 0)
    assert 0xFF60 in dict(main_of("jp2_ppm.jp2")[0])
    for name in ("jp2_ppt.jp2", "jp2_ppt_bypass_rgn.j2k", "sphere_jp2_archival.jp2"):
        main, parts = main_of(name)
        assert all(0xFF61 in dict(segs) for _, _, _, segs, _ in parts), name
    main, parts = main_of("sphere_jp2_archival.jp2")
    assert dict(main)[0xFF52][8] == 1 and dict(main)[0xFF5E] == bytes([0, 0, 4]) and len(parts) == 16


def test_cv2_rules_the_fixtures_pin():
    """The rules the fixtures pin, spelled out: lossless files give the
    source back; LA gives no image under IMREAD_UNCHANGED and its grey
    repeated under IMREAD_COLOR; 16-bit grey shifts right by 8 there; a
    12-bit file is uint16 unshifted; a 20-bit one is none unchanged; a
    palette gives its colours under IMREAD_COLOR and their grey under
    IMREAD_UNCHANGED; a greyscale colr repeats the first component."""
    import sys

    sys.path.insert(0, str(JP2_FIXTURES.parents[2] / "scripts"))
    from port_make_image_fixtures import toy_alpha
    from port_make_jpeg_fixtures import photo

    rgb = photo(61, 83, seed=1)

    def read(name, f=IMREAD_UNCHANGED):
        return tproc.read_image(str(JP2_FIXTURES / name), f)

    np.testing.assert_array_equal(read("jp2_rgb_53.jp2"), rgb)
    np.testing.assert_array_equal(read("jp2_rgba_53.jp2"), np.dstack([rgb, toy_alpha(61, 83)]))
    with pytest.raises(ValueError, match="two channels"):
        read("jp2_la_53.jp2")
    la = read("jp2_la_53.jp2", IMREAD_COLOR)
    np.testing.assert_array_equal(la, np.repeat(read("jp2_l_53.jp2")[..., None], 3, -1))
    i16 = read("jp2_i16_53.jp2")
    assert i16.dtype == np.uint16
    np.testing.assert_array_equal(read("jp2_i16_53.jp2", IMREAD_COLOR)[..., 0], i16 >> 8)
    p12 = read("jp2_prec12.jp2")
    assert p12.dtype == np.uint16 and p12.max() <= 4095
    with pytest.raises(ValueError, match="20-bit"):
        read("jp2_prec20.jp2")
    pal = read("jp2_palette.jp2", IMREAD_COLOR).astype(np.int64)
    grey = read("jp2_palette.jp2")
    np.testing.assert_array_equal(grey, (pal[..., 2] * 3735 + pal[..., 1] * 19235
                                         + pal[..., 0] * 9798 + 16384) >> 15)
    np.testing.assert_array_equal(read("jp2_colr_grey.jp2"),
                                  np.repeat(read("jp2_rgb_rct.jp2")[..., :1], 3, -1))


# ------------------------------------------------------------------ seeded files

PILLOW_CASES = {
    "lossless": {}, "irreversible": dict(irreversible=True),
    "rct": dict(mct=1), "ict": dict(mct=1, irreversible=True),
    "rates": dict(mct=1, irreversible=True, quality_mode="rates", quality_layers=[50, 20, 6]),
    "db": dict(irreversible=True, quality_mode="dB", quality_layers=[28, 36, 44]),
    "lossless_layers": dict(quality_mode="rates", quality_layers=[16, 4]),
    "res1": dict(num_resolutions=1), "res2": dict(num_resolutions=2),
    "res6": dict(num_resolutions=6, irreversible=True),
    "cblk4x64": dict(codeblock_size=(4, 64)), "cblk32x8": dict(codeblock_size=(32, 8)),
    "precincts16": dict(precinct_size=(16, 16), codeblock_size=(4, 4), num_resolutions=3),
    "tiles16": dict(tile_size=(16, 16), mct=1, irreversible=True),
    "tiles40x24": dict(tile_size=(40, 24), num_resolutions=4),
    "tiles32_res6": dict(tile_size=(32, 32), num_resolutions=6, quality_mode="rates",
                         quality_layers=[30, 8], irreversible=True),
    "plt": dict(plt=True), "comment": dict(comment="seeded"),
    "codestream": dict(no_jp2=True),
}
PILLOW_CASES.update({
    f"{order.lower()}_{n}x{layers}": dict(
        progression=order, num_resolutions=n, quality_mode="rates",
        quality_layers=[30, 10, 3][:layers], mct=1,
        precinct_size=(16, 16) if n == 3 else None, tile_size=(48, 32) if n == 4 else None)
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
    for n, layers in ((2, 1), (3, 2), (4, 3))})


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("case", list(PILLOW_CASES))
def test_pillow_files_read_as_cv2_reads_them(tmp_path, case, mode):
    kw = {k: v for k, v in PILLOW_CASES[case].items() if v is not None}
    img = RGBA if mode == "RGBA" else IMG
    grey_codestream = mode == "L" and case == "codestream"     # sRGB to cv2: none in colour
    _same_as_cv2(F.jp2_pillow(img, mode=mode if mode == "L" else None, **kw), tmp_path / "x.jp2",
                 none=(IMREAD_COLOR,) if grey_codestream else ())


@pytest.mark.parametrize("kw", [{}, dict(irreversible=True), dict(no_jp2=True)],
                         ids=["53", "97", "codestream"])
def test_sixteen_bit_and_grey_alpha_files(kw):
    """I;16 (uint16 unchanged, >> 8 under IMREAD_COLOR) and LA (none
    unchanged; under IMREAD_COLOR its grey repeated from a JP2, none from a
    bare codestream, which cv2 takes as sRGB)."""
    deep = (IMG[..., 0].astype(np.uint16) * 251 + 7).astype(np.uint16)
    _same_as_cv2(F.jp2_pillow(deep, **kw), none=() if "no_jp2" not in kw else (IMREAD_COLOR,))
    la = F.jp2_pillow(RGBA, mode="LA", **kw)
    _same_as_cv2(la, none=(IMREAD_UNCHANGED,) if "no_jp2" not in kw else (IMREAD_UNCHANGED,
                                                                          IMREAD_COLOR))
    _same_as_cv2(F.jp2_pillow(IMG, mode="L", **kw),
                 none=() if "no_jp2" not in kw else (IMREAD_COLOR,))


def test_cinema_profiles_and_their_poc():
    """Pillow's digital-cinema profiles: 2K, and 4K with its POC marker
    (two progression volumes), also moved into the tile-part headers."""
    _same_as_cv2(F.jp2_pillow(IMG, cinema_mode="cinema2k-24"), none=())
    c4k = F.jp2_pillow(F.photo(64, 96, 9), cinema_mode="cinema4k-24")
    assert b"\xff\x5f" in F.jp2_codestream(c4k)[:400]
    _same_as_cv2(c4k, none=())
    _same_as_cv2(F.jp2_rebuild(c4k, codestream=F.j2k_poc_in_tiles(F.jp2_codestream(c4k))), none=())


@pytest.mark.parametrize("kw", [dict(mct=1), dict(tile_size=(32, 32), num_resolutions=3,
                                                  progression="RPCL", precinct_size=(16, 16),
                                                  quality_mode="rates", quality_layers=[20, 5])],
                         ids=["one_tile", "tiles_rpcl"])
def test_tile_parts_tlm_sop_coc_qcc(kw):
    """Rewrites of a Pillow codestream that keep its decode: every tile over
    two tile-parts (with a TLM marker), SOP before every packet, COC and QCC
    in the main and the tile-part headers."""
    d = F.jp2_pillow(IMG, plt=True, **kw)
    cs = F.jp2_codestream(d)
    for out in (F.j2k_split_tile_parts(cs), F.j2k_split_tile_parts(cs, tlm=True),
                F.j2k_with_sop(cs), F.j2k_per_component_markers(cs, "main"),
                F.j2k_per_component_markers(cs, "tile")):
        _same_as_cv2(F.jp2_rebuild(d, codestream=out), none=())
        _same_as_cv2(out, none=())


@pytest.mark.parametrize("precs", [[16], [12], [9], [20], [8], [7], [24], [12, 8, 8], [8, 8, 10],
                                   [10, 10, 10], [17, 8, 8]])
def test_siz_precisions(precs):
    """Every precision against cv2: below 8 none, 9 to 16 uint16, above 16
    none unchanged and shifted to 8 bits under IMREAD_COLOR; mixed ones
    follow the largest; the data of 5/3 and 9/7 files alike."""
    src = (IMG[..., 0].astype(np.uint16) * 257) if len(precs) == 1 else IMG
    for kw in ({}, dict(irreversible=True)):
        d = F.jp2_pillow(src, **kw)
        _same_as_cv2(F.jp2_rebuild(d, codestream=F.j2k_set_precision(F.jp2_codestream(d), precs)))


@pytest.mark.parametrize("enumcs", [16, 17, 18, 12, 24, 14, 99, 0])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I16"])
def test_colour_spaces(enumcs, mode):
    """colr's enumerations: sRGB, greyscale (the first component repeated),
    sYCC (cv2's YUV2BGR, at 8 and 16 bits), CMYK and e-sYCC (none), CIELab
    and unknown ones taken as sRGB; and an ICC profile."""
    if mode == "I16":
        d = F.jp2_pillow(IMG[..., 0].astype(np.uint16) * 256 + 128)
    else:
        d = F.jp2_pillow(RGBA if mode == "RGBA" else IMG, mode=mode if mode == "L" else None)
    _same_as_cv2(F.jp2_rebuild(d, F.jp2_header_with(F.jp2_colr(enumcs))))
    _same_as_cv2(F.jp2_rebuild(d, F.jp2_header_with(F.jp2_colr(icc=bytes(64)))))


def test_sycc_at_sixteen_bits():
    d = F.jp2_pillow(IMG, mct=1)
    cs = F.j2k_set_precision(F.jp2_codestream(d), [12, 12, 12])
    _same_as_cv2(F.jp2_rebuild(d, F.jp2_header_with(F.jp2_colr(18)), codestream=cs), none=())


CDEFS = {
    "standard": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)],
    "bgr": [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)],
    "rotated": [(3, 0, 1), (0, 0, 2), (1, 0, 3), (2, 1, 0)],
    "alpha_first": [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)],
    "premultiplied": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)],
    "unspecified": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 65535, 65535)],
    "swap_last": [(0, 0, 4), (1, 0, 2), (2, 0, 3), (3, 0, 1)],
    "incomplete": [(0, 0, 1), (1, 0, 2), (2, 0, 3)],
    "bad_association": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 5)],
    "bad_channel": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (4, 1, 0)],
}


@pytest.mark.parametrize("name", list(CDEFS))
def test_channel_definitions(name):
    """cdef as OpenJPEG applies it (colour channels swapped to their
    association in the box's order; cv2 never reads the alpha flags) and
    checks it (every channel defined, every index in range)."""
    for img, drop in ((RGBA, (b"cdef",)), (IMG, ())):
        entries = [e for e in CDEFS[name] if img.shape[2] == 4 or max(e[0], e[2] - 1) < 3]
        d = F.jp2_pillow(img)
        _same_as_cv2(F.jp2_rebuild(d, F.jp2_header_with(drop=drop, extra=[(b"cdef",
                                                                           F.jp2_cdef(entries))])))


PALETTES = {
    "rgb": ([8, 8, 8], [(0, 1, 0), (0, 1, 1), (0, 1, 2)], 16),
    "rgba": ([8, 8, 8, 8], [(0, 1, 0), (0, 1, 1), (0, 1, 2), (0, 1, 3)], 16),
    "deep": ([16, 12, 10], [(0, 1, 0), (0, 1, 1), (0, 1, 2)], 16),
    "grey_space": ([8, 8, 8], [(0, 1, 0), (0, 1, 1), (0, 1, 2)], 17),
    "sycc_space": ([8, 8, 8], [(0, 1, 0), (0, 1, 1), (0, 1, 2)], 18),
    "one_column": ([8], [(0, 1, 0)], 17),
    "direct_first": ([8, 8, 8], [(0, 0, 0), (0, 1, 1), (0, 1, 2)], 16),
    "unmapped": ([8, 8, 8], [(0, 0, 0), (0, 0, 0), (0, 1, 2)], 16),
    "swapped": ([8, 8, 8], [(0, 1, 2), (0, 1, 1), (0, 1, 0)], 16),
    "bad_component": ([8, 8, 8], [(1, 1, 0), (0, 1, 1), (0, 1, 2)], 16),
    "no_cmap": ([8, 8, 8], None, 16),
}


@pytest.mark.parametrize("entries", [32, 256])
@pytest.mark.parametrize("name", list(PALETTES))
def test_palettes(name, entries):
    """pclr and cmap over an 8-bit index codestream (a palette shorter than
    the indices clamps them), and a 16-bit one."""
    rng = np.random.default_rng(entries)
    depths, cmap, enumcs = PALETTES[name]
    pal = np.stack([rng.integers(0, 1 << d, entries) for d in depths], 1)
    boxes = [(b"pclr", F.jp2_pclr(pal, depths))] + ([(b"cmap", F.jp2_cmap(cmap))] if cmap else [])
    for index in (IMG[..., 1], IMG[..., 1].astype(np.uint16) * 3):
        d = F.jp2_pillow(index)
        _same_as_cv2(F.jp2_rebuild(d, F.jp2_header_with(F.jp2_colr(enumcs), extra=boxes)))


# ------------------------------------------------------------------ OpenJPEG's own encoder

def test_openjpeg_parameter_layout():
    """The ctypes layout of ``opj_cparameters_t``: the library's defaults
    land on the fields named, and each field set comes back in the markers
    the library writes (COD's Scod, progression, layers, MCT, levels,
    code-block size and style, transform; SIZ's tile size; RGN; and the
    Part 2 custom MCT's Rsiz and MCT/MCC/MCO markers)."""
    p = F.openjpeg_defaults()
    assert (p.numresolution, p.cblockw_init, p.cblockh_init, p.prog_order, p.roi_compno,
            p.subsampling_dx, p.subsampling_dy, p.decod_format, p.cod_format, p.tcp_numlayers,
            p.rsiz, p.tcp_mct) == (6, 64, 64, 0, -1, 1, 1, -1, -1, 0, 0, b"\0")
    d = F.jp2_openjpeg(IMG, csty=6, mode=0x3F, roi=(1, 9), irreversible=True, rates=(30, 10),
                       tile=(32, 16), resolutions=4, cblk=(32, 16), order="RPCL", mct=1)
    main, parts = F.j2k_parse(F.jp2_codestream(d))
    cod = dict(main)[0xFF52]
    assert tuple(cod[:10]) == (6, 2, 0, 2, 1, 3, 3, 2, 0x3F, 0)
    assert struct.unpack_from(">II", dict(main)[0xFF51], 18) == (32, 16)
    assert dict(main)[0xFF5E] == bytes([1, 0, 9]) and len(parts) == 3 * 3
    custom = F.jp2_openjpeg(IMG, matrix=np.eye(3)[[2, 0, 1]] * 0.5 + 0.1, mct=2)
    main, _ = F.j2k_parse(F.jp2_codestream(custom))
    assert struct.unpack_from(">H", dict(main)[0xFF51])[0] & 0x8100 == 0x8100
    assert {0xFF74, 0xFF75, 0xFF77} <= set(dict(main))
    # OpenJPEG 2.5 does not read its own custom MCT back (COD's MCT field 2
    # is refused), so cv2 gives none; the port refuses Part 2 by name.
    assert cv2.imdecode(np.frombuffer(custom, np.uint8), IMREAD_UNCHANGED) is None
    with pytest.raises(NotImplementedError, match="Part 2"):
        decode_image(custom)


MODES = {"bypass": 1, "reset": 2, "restart": 4, "causal": 8, "erterm": 16, "segmark": 32,
         "reset_restart_causal_erterm_segmark": 62, "all_six": 63}
SETTINGS = {"53": {}, "97_layers": dict(irreversible=True, rates=(40, 10, 5)),
            "tiles_layers": dict(tile=(32, 32), rates=(20, 5))}
CHANNELS = {"L": IMG[..., 0], "RGB": IMG, "RGBA": RGBA}


@pytest.mark.parametrize("channels", list(CHANNELS))
@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("mode", list(MODES))
def test_code_block_styles_read_as_cv2_reads_them(mode, setting, channels):
    """Each code-block style flag alone, the error-resilient five
    together and all six, as OpenJPEG's encoder writes them: raw (bypass)
    passes, contexts reset after each pass, a segment per pass, vertically
    causal contexts, predictable termination, segmentation symbols."""
    _same_as_cv2(F.jp2_openjpeg(CHANNELS[channels], mode=MODES[mode], **SETTINGS[setting]),
                 none=())


@pytest.mark.parametrize("channels", list(CHANNELS))
@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("markers", ["eph", "sop_eph"])
def test_eph_markers_read_as_cv2_reads_them(markers, setting, channels):
    _same_as_cv2(F.jp2_openjpeg(CHANNELS[channels], csty=6 if markers == "sop_eph" else 4,
                                **SETTINGS[setting]), none=())


@pytest.mark.parametrize("where", ["main", "tile"])
@pytest.mark.parametrize("shift", [1, 7, 20, 40])
@pytest.mark.parametrize("channels", list(CHANNELS))
def test_roi_shifts_read_as_cv2_reads_them(channels, shift, where):
    """A maxshift RGN marker on the first or the last component, in the
    main header or the tile-part headers, over 5/3, 9/7 and tiled layered
    data: the planes start ``shift`` higher and the magnitudes at or above
    ``1 << shift`` come down; 20 lies past every block's bit-plane count
    (and past 30 planes with some 9/7 blocks', where OpenJPEG fails the
    block: none), 40 past 30 planes with every block's."""
    img = CHANNELS[channels]
    comps = img.shape[2] if img.ndim == 3 else 1
    for k, setting in enumerate(SETTINGS.values()):
        d = F.jp2_openjpeg(img, **setting)
        cs = F.j2k_rgn(F.jp2_codestream(d), (comps - 1) * (k % 2), shift, where)
        none = {40: (IMREAD_UNCHANGED, IMREAD_COLOR), 20: None}.get(shift, ())
        _same_as_cv2(F.jp2_rebuild(d, codestream=cs), none=none)
    _same_as_cv2(F.jp2_openjpeg(img, roi=(0, min(shift, 30)), mode=1, rates=(20, 5)))


PACKED = {"eph_sop": (True, True), "eph": (True, False), "sop": (False, True),
          "bare": (False, False)}


@pytest.mark.parametrize("channels", list(CHANNELS))
@pytest.mark.parametrize("headers", list(PACKED))
@pytest.mark.parametrize("where", ["ppm", "ppt"])
def test_packed_packet_headers_read_as_cv2_reads_them(where, headers, channels):
    """Packet headers moved into PPM markers (an Nppm per tile-part) or PPT
    markers, with and without EPH markers in them and SOP markers before
    the bodies, in one marker per tile-part and spread over several (an
    Nppm's bytes running on into the next PPM marker), also with each tile
    over a tile-part per resolution."""
    eph, sop = PACKED[headers]
    for setting in [*SETTINGS.values(), dict(tile=(32, 32), rates=(20, 5), order="RPCL",
                                              tile_parts="R")]:
        d = F.jp2_openjpeg(CHANNELS[channels], csty=6, **setting)
        for chunk in (65532, 37):
            cs = F.j2k_packed_headers(F.jp2_codestream(d), where, eph, sop, chunk)
            assert (0xFF60 in dict(F.j2k_parse(cs)[0])) == (where == "ppm")
            _same_as_cv2(F.jp2_rebuild(d, codestream=cs), none=())


def _reversed_tiles(parts):
    return sorted(parts, key=lambda p: -p[0])


def _interleaved_tiles(parts):
    """Each tile's tile-parts in order, the tiles taken round-robin from the
    last index down: T3.0, T2.0, T1.0, T0.0, T3.1, ..."""
    by_tile: dict = {}
    for p in parts:
        by_tile.setdefault(p[0], []).append(p)
    tiles = sorted(by_tile, reverse=True)
    return [by_tile[t][k] for k in range(max(map(len, by_tile.values()))) for t in tiles
            if k < len(by_tile[t])]


def _by_index(heads):
    return sorted(heads, key=lambda h: h[:2])


def _by_completion(heads):
    """Each tile's headers together, the tiles in the order their last
    tile-part comes (OpenJPEG's decode order when TNsot is known)."""
    last = {isot: i for i, (isot, _, _) in enumerate(heads)}
    return sorted(heads, key=lambda h: (last[h[0]], h[1]))


# name: (tile-part order, TNsot, PPM's order)
PPM_ORDERS = {
    "reversed": (_reversed_tiles, None, None),
    "reversed_tnsot_unknown": (_reversed_tiles, 0, None),
    "reversed_tnsot_unknown_headers_by_index": (_reversed_tiles, 0, _by_index),
    "interleaved": (_interleaved_tiles, None, None),
    "interleaved_headers_by_tile": (_interleaved_tiles, None, _by_completion),
    "interleaved_tnsot_unknown_headers_by_index": (_interleaved_tiles, 0, _by_index),
}


@pytest.mark.parametrize("order", list(PPM_ORDERS))
def test_ppm_tile_parts_out_of_index_order_read_as_cv2_reads_them(order):
    """A PPM file whose tile-parts come out of index order (the tiles
    backwards, or their tile-parts, one per resolution, interleaved
    backwards), with TNsot as written or 0 (not known), the packed headers
    laid out tile-part by tile-part as they come or in another order: the
    decode, or the refusal, as cv2's under both flags. OpenJPEG reads the
    headers in its decode order (a tile when its last tile-part by TNsot
    comes, tiles of unknown TNsot by index at the end), so the files whose
    headers follow that order decode."""
    fn, tnsot, ppm_order = PPM_ORDERS[order]
    d = F.jp2_openjpeg(IMG, csty=6, tile=(32, 32), rates=(20, 5),
                       **({"order": "RPCL", "tile_parts": "R"} if "interleaved" in order else {}))
    cs = F.j2k_packed_headers(F.jp2_codestream(d), "ppm", order=fn, tnsot=tnsot,
                              ppm_order=ppm_order)
    isots = [p[0] for p in F.j2k_parse(cs)[1]]
    assert isots != sorted(isots)
    decodes = order in ("reversed", "reversed_tnsot_unknown_headers_by_index",
                        "interleaved_headers_by_tile", "interleaved_tnsot_unknown_headers_by_index")
    _same_as_cv2(F.jp2_rebuild(d, codestream=cs),
                 none=() if decodes else (IMREAD_UNCHANGED, IMREAD_COLOR))


def _malformed_packed() -> dict:
    d = F.jp2_openjpeg(IMG, csty=6, tile=(32, 32), rates=(20, 5))
    ppm = F.j2k_packed_headers(F.jp2_codestream(d), "ppm")
    ppt = F.j2k_packed_headers(F.jp2_codestream(d), "ppt", chunk=20)
    main, parts = F.j2k_parse(ppm)
    ppm_at = next(i for i, (m, _) in enumerate(main) if m == 0xFF60)
    seg = main[ppm_at][1]
    nppm = struct.unpack_from(">I", seg, 1)[0]

    def with_ppm(*payloads):
        return F.j2k_build(main[:ppm_at] + [(0xFF60, p) for p in payloads] + main[ppm_at + 1:],
                           parts)

    tmain, tparts = F.j2k_parse(ppt)

    def with_ppt(edit):
        return F.j2k_build(tmain, [(i, tp, tn, edit(segs), x) for i, tp, tn, segs, x in tparts])

    return {
        "nppm_past_the_data": with_ppm(seg[:1] + struct.pack(">I", nppm + 9) + seg[5:]),
        "nppm_field_split": with_ppm(seg[:3], b"\1" + seg[3:]),
        "nppm_zero": with_ppm(b"\0" + bytes(4)),
        "zppm_twice": with_ppm(seg, seg),
        "zppm_gap": with_ppm(b"\2" + seg[1:]),
        "headers_cut": with_ppm(seg[:1] + struct.pack(">I", nppm - 7) + seg[5:5 + nppm - 7]
                                + seg[5 + nppm:]),
        "ppt_with_ppm": F.j2k_build(main, [(i, tp, tn, segs + [(0xFF61, b"\0\0")], x)
                                           for i, tp, tn, segs, x in parts]),
        "zppt_twice": with_ppt(lambda segs: segs + [s for s in segs if s[0] == 0xFF61][:1]),
        "zppt_reversed": with_ppt(lambda segs: segs[::-1]),
        "zppt_renumbered": with_ppt(lambda segs: [(m, bytes([2 * p[0] + 1]) + p[1:])
                                                  if m == 0xFF61 else (m, p) for m, p in segs]),
        "ppt_short": with_ppt(lambda segs: segs + [(0xFF61, b"\x7f")]),
        "ppt_dropped": with_ppt(lambda segs: [s for s in segs if s[0] != 0xFF61][:1]
                                + [s for s in segs if s[0] == 0xFF61][1:]),
        "no_byte_after_sod": _empty_packets(b""),
        "one_byte_after_sod": _empty_packets(b"\0"),
    }


def _empty_packets(body: bytes) -> bytes:
    """Every packet empty (header 0x00 in PPT markers, no EPH or SOP), and
    ``body`` as each tile-part's data: OpenJPEG fails a tile with no byte
    after SOD, and reads one with any."""
    d = F.jp2_openjpeg(IMG, csty=6, tile=(32, 32), rates=(20, 5))
    main, parts = F.j2k_parse(F.jp2_codestream(d))
    main = [(m, bytes([p[0] & ~6]) + p[1:] if m == 0xFF52 else p) for m, p in main]
    return F.j2k_build(main, [(i, tp, tn, segs + [(0xFF61, bytes(1 + len(F.j2k_packets(x))))], body)
                              for i, tp, tn, segs, x in parts])


MALFORMED_PACKED = _malformed_packed()


@pytest.mark.parametrize("case", list(MALFORMED_PACKED))
def test_malformed_packed_headers_as_cv2_reads_them(case):
    """PPM and PPT markers that lie: Nppm past the data, an Nppm field
    split over two markers, no headers, an index read twice, a gap in the
    indices, headers cut short, PPT beside PPM, markers out of order or
    missing; tiles of empty packets with no byte or one after SOD. Equal to
    cv2's decode, or both give none."""
    _same_as_cv2(MALFORMED_PACKED[case])


# ------------------------------------------------------------------ broken and refused

def test_truncated_and_corrupted_streams_raise_value_error(tmp_path):
    """Cut short anywhere, with a SIZ that lies, a tile-part longer than the
    file, or a marker where a segment should be: cv2 gives none and the
    port raises ValueError naming JPEG 2000."""
    d = F.jp2_pillow(IMG, tile_size=(32, 32), mct=1)
    cs = F.jp2_codestream(d)
    broken = [d[:n] for n in (40, 100, len(d) // 3, len(d) // 2, len(d) - 300, len(d) - 2)]
    broken += [cs[:n] for n in (20, len(cs) // 2, len(cs) - 1, len(cs) - 2)]
    broken += [cs[:4] + b"\0\x05" + cs[6:],                       # Lsiz
               cs[:42] + b"\x80" + cs[43:],                       # signed precision
               cs.replace(b"\xff\x90\x00\x0a\x00\x01", b"\xff\x90\x00\x0a\x00\x09", 1),
               cs[:-2] + b"junkjunk", cs.replace(b"\xff\x5c", b"\xff\x30", 1)]
    for i, data in enumerate(broken):
        for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
            assert cv2.imdecode(np.frombuffer(data, np.uint8), f) is None, i
            with pytest.raises(ValueError, match="JPEG 2000"):
                decode_image(data, f)
        (tmp_path / "x.jp2").write_bytes(data)
        with pytest.raises(FileNotFoundError):
            tproc.load_rgba(str(tmp_path / "x.jp2"), device="cpu")


@pytest.mark.parametrize("tnsot", [1, 0])
def test_the_codestreams_end_as_openjpeg_reads_it(tnsot):
    """What may follow the last tile-part: EOC (and anything after it), any
    two bytes (with some TNsot unknown, OpenJPEG then decodes the last
    tile alone), nothing when some TNsot is unknown; a missing tile is left
    zero. Each against cv2, none included."""
    cs = F.jp2_codestream(F.jp2_pillow(IMG, tile_size=(32, 32), mct=1))
    main, parts = F.j2k_parse(cs)
    parts = [(i, tp, tnsot, s, x) for i, tp, _, s, x in parts]
    full = F.j2k_build(main, parts)
    for data in (full, full + b"junk", full[:-2], full[:-2] + b"\xff", full[:-2] + b"\0\0",
                 full[:-2] + b"\xff\xd8", full[:-2] + b"junkjunk", full[:-2] + b"\xff\x90\0",
                 F.j2k_build(main, parts[:-1]), F.j2k_build(main, parts[:-1])[:-2]):
        _same_as_cv2(data)


CORRUPTED_BASES = {
    "jp2_53": dict(mct=1),
    "jp2_97_tiles": dict(irreversible=True, tile_size=(16, 16), mct=1),
    "j2k_rpcl_layers": dict(progression="RPCL", precinct_size=(16, 16), num_resolutions=3,
                            quality_mode="rates", quality_layers=[20, 5], no_jp2=True),
}


@pytest.mark.parametrize("base", list(CORRUPTED_BASES))
def test_corrupted_streams_read_as_cv2_reads_them(base):
    """Seeded corruptions (bytes overwritten, cut out, put in) anywhere in
    the file: the port's decode equals cv2's, or both give none. Corrupt
    coded data decodes to the same pixels; the headers fail where
    OpenJPEG's do (an unknown marker is skipped to the next known one, a
    jp2c box runs to the end whatever its length, the JP2 ihdr must agree
    with SIZ, a tile short of its TNsot is decoded with what it has)."""
    rng = np.random.default_rng(sorted(CORRUPTED_BASES).index(base))
    _corrupted_as_cv2(F.jp2_pillow(F.photo(40, 50, 1), **CORRUPTED_BASES[base]), rng)


def _corrupted_as_cv2(src: bytes, rng) -> None:
    for _ in range(40):
        d = bytearray(src)
        for _ in range(int(rng.integers(1, 4))):
            at, kind = int(rng.integers(0, len(d))), int(rng.integers(0, 3))
            if kind == 0:
                d[at] = int(rng.integers(0, 256))
            elif kind == 1:
                del d[at:at + int(rng.integers(1, 40))]
            else:
                d[at:at] = rng.integers(0, 256, int(rng.integers(1, 12))).astype(np.uint8).tobytes()
        data = bytes(d)
        for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
            want = _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), f))
            try:
                got = decode_image(data, f)
            except NotImplementedError:            # a feature the port refuses, by name
                continue
            except (ValueError, FileNotFoundError):   # FileNotFoundError: no signature left
                assert want is None
                continue
            assert want is not None and got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def _archival_corruption_base(kind: str) -> bytes:
    img = F.photo(40, 50, 1)
    if kind == "eph":
        return F.jp2_openjpeg(img, csty=6, mode=62, rates=(20, 5), irreversible=True)
    if kind == "bypass":
        return F.jp2_openjpeg(img, mode=1, rates=(20, 5), tile=(32, 32))
    d = F.jp2_openjpeg(img, csty=6, mode=1, rates=(20, 5), tile=(16, 16), resolutions=3)
    return F.jp2_rebuild(d, codestream=F.j2k_packed_headers(F.jp2_codestream(d), "ppt"))


@pytest.mark.parametrize("base", ["eph", "ppt", "bypass"])
def test_corrupted_archival_streams_read_as_cv2_reads_them(base):
    """The seeded corruptions above on files with SOP and EPH markers and
    RESET|RESTART|CAUSAL|ERTERM|SEGMARK blocks (a missing EPH fails the
    tile in OpenJPEG 2.5, a missing SOP, a failed ERTERM check or a bad
    segmentation symbol does not), with BYPASS-coded blocks, and with
    packet headers in PPT markers: equal to cv2's decode, or both give
    none."""
    _corrupted_as_cv2(_archival_corruption_base(base),
                      np.random.default_rng(100 + ["eph", "ppt", "bypass"].index(base)))


REFUSED = {
    "HTJ2K": ("cod", 8, 0x40),
    "Part 2 arbitrary wavelet": ("cod", 9, 0x02),
    "multi-component transform": ("marker", 0xFF74, b"\0\0\0\0\0"),
    "CAP marker": ("marker", 0xFF50, b"\0\x02\0\0\0\0"),
}
READ_NOW = {                    # refused by name before the port read them
    "selective arithmetic coding bypass": ("cod", 8, 0x01),
    "reset of context probabilities": ("cod", 8, 0x02),
    "termination on each coding pass": ("cod", 8, 0x04),
    "vertically causal context formation": ("cod", 8, 0x08),
    "predictable termination": ("cod", 8, 0x10),
    "segmentation symbols": ("cod", 8, 0x20),
    "EPH markers": ("cod", 0, 0x04),
    "region of interest": ("marker", 0xFF5E, b"\0\0\x05"),
    "PPM marker": ("marker", 0xFF60, b"\0\0\0\0\0"),
    "PPT marker": ("tile", 0xFF61, b"\0"),
}


def _flag_rewritten(feature: str) -> tuple[bytes, bytes]:
    """A Pillow file (and its codestream) with one coding option switched on
    by rewriting its headers: the coded data is not recoded for it."""
    d = F.jp2_pillow(IMG, mct=1)
    cs = F.jp2_codestream(d)
    kind, a, b = {**REFUSED, **READ_NOW}[feature]
    if kind == "cod":
        main, parts = F.j2k_parse(cs)
        cod = next(p for m, p in main if m == 0xFF52)
        out = F.j2k_set_cod(cs, a, cod[a] | b)
    elif kind == "marker":
        main, parts = F.j2k_parse(cs)
        out = F.j2k_build(main + [(a, b)], parts)
    else:
        main, parts = F.j2k_parse(cs)
        out = F.j2k_build(main, [(i, tp, tn, [(a, b)] + s, x) for i, tp, tn, s, x in parts])
    return out, F.jp2_rebuild(d, codestream=out)


@pytest.mark.parametrize("feature", list(READ_NOW))
def test_features_once_refused_read_as_cv2_reads_them(tmp_path, feature):
    """The flag-rewritten files that were refused by name (the six styles
    read by cv2 as the flag says whatever the data, EPH without its
    markers, an RGN marker, a PPM marker without headers, a PPT marker
    too short): equal to cv2's decode, or both give none."""
    out, jp2 = _flag_rewritten(feature)
    if feature.startswith(("selective", "reset", "termination", "vertically", "predictable",
                           "segmentation", "region")):
        assert cv2.imdecode(np.frombuffer(out, np.uint8), IMREAD_UNCHANGED) is not None
    _same_as_cv2(out, tmp_path / "x.j2k")
    _same_as_cv2(jp2, tmp_path / "x.jp2")


@pytest.mark.parametrize("feature", list(REFUSED))
def test_features_not_read_are_refused_by_name(tmp_path, feature):
    """Each coding option the port does not decode (HTJ2K, Part 2) raises
    NotImplementedError naming it, from a JP2 and a bare codestream."""
    out, jp2 = _flag_rewritten(feature)
    for data in (out, jp2):
        for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
            with pytest.raises(NotImplementedError, match=feature.split()[0]):
                decode_image(data, f)
    (tmp_path / "x.jp2").write_bytes(out)
    with pytest.raises(NotImplementedError, match="JPEG 2000"):
        tproc.load_rgba(str(tmp_path / "x.jp2"), device="cpu")


# ------------------------------------------------------------------ load_rgba and Mesh.load

@pytest.mark.parametrize("name", ["jp2_rgba_53.jp2", "jp2_rgba_97.jp2", "jp2_tiles32.jp2",
                                  "jp2_cdef_alpha_first.jp2"])
def test_load_rgba_of_a_four_channel_jp2_matches_jax(name):
    path = str(JP2_FIXTURES / name)
    ref = jproc.load_rgba(path, size=64)
    got = tproc.load_rgba(path, size=64, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (64, 64, 4)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["jp2_rgb_ict_layers.jp2", "jp2_raw.j2k", "jp2_l_97.jp2",
                                  "jp2_palette.jp2"])
def test_load_rgba_of_an_rgb_or_grey_jp2_matches_jax(name, u2net_files, u2net_at_64):  # noqa: F811
    path = str(JP2_FIXTURES / name)
    ref = jproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (48, 48, 4)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


@pytest.mark.parametrize("name", ["jp2_la_53.jp2", "jp2_signed.jp2", "jp2_prec20.jp2",
                                  "jp2_tiles32_offset.jp2", "jp2_colr_cmyk.jp2"])
def test_load_rgba_where_cv2_reads_none_is_a_missing_file_on_both_sides(name):
    path = str(JP2_FIXTURES / name)
    for load in (jproc.load_rgba, lambda p: tproc.load_rgba(p, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load(path)


def test_jp2_textured_obj_matches_jax():
    path = str(JP2_FIXTURES / "sphere_jp2.obj")
    ref = JMesh.load(path, resize=False)
    got = TMesh.load(path, resize=False)
    assert ref.albedo is not None and got.albedo.shape == ref.albedo.shape == (128, 128, 3)
    np.testing.assert_array_equal(got.albedo, ref.albedo)
    np.testing.assert_array_equal(np.asarray(got.v), np.asarray(ref.v))


@pytest.mark.parametrize("name", ["jp2_rgb_ict_layers.jp2", "jp2_raw.j2k", "jp2_la_97.jp2",
                                  "jp2_cdef_bgr.jp2"])
def test_glb_with_a_jp2_image_matches_jax(tmp_path, name):
    path = _glb_with_image(tmp_path, (JP2_FIXTURES / name).read_bytes())
    ref = JMesh.load(path, resize=False).albedo
    got = TMesh.load(path, resize=False).albedo
    assert ref is not None and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)


def test_jp2_texture_cv2_reads_none_of_raises_and_a_glb_keeps_no_albedo(tmp_path, capsys):
    """cv2.imread of a signed JP2 is None: the JAX Mesh.load raises in
    cv2.cvtColor for an OBJ, and leaves a GLB's albedo unset; the port
    raises ValueError naming JPEG 2000, and leaves it unset."""
    tex = (JP2_FIXTURES / "jp2_signed.jp2").read_bytes()
    (tmp_path / "f.jp2").write_bytes(tex)
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd f.jp2\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "vt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    with pytest.raises(cv2.error):
        JMesh.load(str(tmp_path / "m.obj"), resize=False)
    with pytest.raises(ValueError, match="JPEG 2000"):
        TMesh.load(str(tmp_path / "m.obj"), resize=False)
    glb = _glb_with_image(tmp_path, tex)
    assert JMesh.load(glb, resize=False).albedo is None
    capsys.readouterr()
    assert TMesh.load(glb, resize=False).albedo is None
    assert "does not decode" in capsys.readouterr().out


# ------------------------------------------------------------------ archival files through the apps

@pytest.mark.parametrize("name", ["photo_512_rgba_archival.jp2", "jp2_sop_eph_layers.jp2",
                                  "jp2_mode_all.jp2", "jp2_rgn_tiles.jp2", "jp2_ppt.jp2"])
def test_load_rgba_of_a_four_channel_archival_jp2_matches_jax(name):
    path = str(JP2_ARCHIVAL_FIXTURES / name)
    ref = jproc.load_rgba(path, size=64)
    got = tproc.load_rgba(path, size=64, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (64, 64, 4)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["jp2_ppm.jp2", "jp2_ppt_bypass_rgn.j2k",
                                  "jp2_mode_bypass_grey.jp2", "photo_1024x768_bypass.jp2"])
def test_load_rgba_of_an_rgb_or_grey_archival_jp2_matches_jax(name, u2net_files,  # noqa: F811
                                                              u2net_at_64):  # noqa: F811
    path = str(JP2_ARCHIVAL_FIXTURES / name)
    ref = jproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (48, 48, 4)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


def test_load_rgba_of_an_archival_jp2_cv2_reads_none_of_is_a_missing_file_on_both_sides():
    path = str(JP2_ARCHIVAL_FIXTURES / "jp2_rgn_past.jp2")
    for load in (jproc.load_rgba, lambda p: tproc.load_rgba(p, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load(path)


def test_archival_jp2_textured_obj_matches_jax():
    """The sphere whose texture is BYPASS-coded in 32^2 tiles with PPT
    markers and an RGN marker on component 0."""
    path = str(JP2_ARCHIVAL_FIXTURES / "sphere_jp2_archival.obj")
    ref = JMesh.load(path, resize=False)
    got = TMesh.load(path, resize=False)
    assert ref.albedo is not None and got.albedo.shape == ref.albedo.shape == (128, 128, 3)
    np.testing.assert_array_equal(got.albedo, ref.albedo)
    np.testing.assert_array_equal(np.asarray(got.v), np.asarray(ref.v))


@pytest.mark.parametrize("name", ["jp2_mode_archival.jp2", "jp2_ppt.jp2",
                                  "jp2_ppt_bypass_rgn.j2k", "jp2_rgn_main.jp2"])
def test_glb_with_an_archival_jp2_image_matches_jax(tmp_path, name):
    path = _glb_with_image(tmp_path, (JP2_ARCHIVAL_FIXTURES / name).read_bytes())
    ref = JMesh.load(path, resize=False).albedo
    got = TMesh.load(path, resize=False).albedo
    assert ref is not None and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)
