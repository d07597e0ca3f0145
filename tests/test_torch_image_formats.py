"""The port's image reader (``utils/imread.py`` with ``utils/png.py``,
``webp.py``, ``bmp.py``, ``pnm.py``, ``gif.py`` and ``csrc/image_codecs.cpp``)
against ``cv2.imread`` under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``, and
what reads through it against the JAX package: ``load_rgba`` and the mesh
textures of ``Mesh.load``.

Tolerance: every decode equal to cv2's bit for bit (dtype, shape, values;
channels in RGB order), on the checked-in fixtures of
``scripts/port_make_image_fixtures.py`` (and their stored digests) and on
files made here from numpy seeds; ``Mesh.load`` albedos equal to the JAX
package's exactly; ``load_rgba`` of a 4-channel input equal exactly, of an
RGB or grey input matted by the same random U2Net at
``test_torch_jpeg.py``'s tolerances (RGB equal, alpha within 1/255)."""

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
from dreamgaussian_tpu_torch.utils.resize import resize_area
from test_torch_process import u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import IMAGE_FIXTURES, iou, scene

DIGESTS = json.loads((IMAGE_FIXTURES / "decodes.json").read_text())
IMAGES = sorted(n for n in DIGESTS if not n.endswith(".glb"))
FLAGS = {"unchanged": IMREAD_UNCHANGED, "color": IMREAD_COLOR}


def _cv2(data: bytes, flags: int):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def _same_as_cv2(data: bytes, flags=(IMREAD_UNCHANGED, IMREAD_COLOR)):
    for f in flags:
        want, got = _cv2(data, f), decode_image(data, f)
        assert want is not None
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fixtures

@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", IMAGES)
def test_fixture_reads_as_cv2_read_it(name, key):
    data = (IMAGE_FIXTURES / name).read_bytes()
    want = DIGESTS[name][key]
    if want is None:                # the 4-channel PAM under IMREAD_COLOR
        with pytest.raises(NotImplementedError, match="PAM"):
            tproc.read_image(str(IMAGE_FIXTURES / name), FLAGS[key])
        return
    got = tproc.read_image(str(IMAGE_FIXTURES / name), FLAGS[key])
    assert [list(got.shape), str(got.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, _cv2(data, FLAGS[key]))
    if key == "unchanged":
        with np.load(IMAGE_FIXTURES / "small_decodes.npz") as small:
            if name in small.files:
                np.testing.assert_array_equal(got, small[name])


MESHES = ["tex_grey.obj", "tex_palette.obj", "tex_exif.obj", "sphere_jpeg.glb"]


@pytest.mark.parametrize("name", MESHES)
def test_mesh_texture_matches_jax(name):
    """A grey PNG, a 4-bit palette PNG and an EXIF-rotated JPEG named by an
    MTL, and a GLB's JPEG base colour: the albedo as the JAX package reads
    it through cv2 (IMREAD_COLOR: three channels, the rotation applied)."""
    path = str(IMAGE_FIXTURES / name)
    ref = JMesh.load(path, resize=False).albedo
    got = TMesh.load(path, resize=False).albedo
    assert ref is not None and got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if name == "tex_exif.obj":
        assert got.shape == (83, 61, 3)               # 83x61 turned by orientation 6


def _glb_with_image(tmp_path, image: bytes) -> str:
    """The sphere fixture with its embedded JPEG replaced by ``image``."""
    raw = (IMAGE_FIXTURES / "sphere_jpeg.glb").read_bytes()
    jlen = struct.unpack_from("<I", raw, 12)[0]
    gltf = json.loads(raw[20:20 + jlen])
    blob = raw[20 + jlen + 8:]
    view = gltf["bufferViews"][gltf["images"][0]["bufferView"]]
    blob = blob[:view["byteOffset"]] + image
    view["byteLength"] = len(image)
    gltf["buffers"][0]["byteLength"] = len(blob)
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    body = struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob), 0x004E4942) + blob
    path = tmp_path / "m.glb"
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return str(path)


def test_glb_image_nothing_decodes_leaves_no_albedo(tmp_path):
    path = _glb_with_image(tmp_path, b"no image at all")
    assert JMesh.load(path, resize=False).albedo is None
    assert TMesh.load(path, resize=False).albedo is None


def _malformed(kind: str) -> bytes:
    """A PNG or WebP base colour that cv2 recognises and cannot decode."""
    if kind.startswith("png"):
        data = cv2.imencode(".png", F.photo(16, 16, 3))[1].tobytes()
        at = data.index(b"IDAT") + 4
        if kind == "png_truncated":
            return data[:at + 30]
        return data[:at + 6] + bytes([data[at + 6] ^ 0xFF]) + data[at + 7:]
    data = (IMAGE_FIXTURES / "webp_lossless.webp").read_bytes()
    return data[:len(data) // 2]


@pytest.mark.parametrize("kind", ["png_truncated", "png_corrupt_idat", "webp_truncated"])
def test_glb_image_that_does_not_decode_leaves_no_albedo_and_warns(tmp_path, capsys, kind):
    """A malformed image of a format both sides read: cv2.imdecode returns
    None and the JAX package loads no texture; the port loads none either,
    and says why, since its own decoder is what refused the bytes."""
    path = _glb_with_image(tmp_path, _malformed(kind))
    assert JMesh.load(path, resize=False).albedo is None
    capsys.readouterr()
    assert TMesh.load(path, resize=False).albedo is None
    assert "does not decode" in capsys.readouterr().out


def test_glb_image_in_a_refused_format_raises_by_name(tmp_path):
    """cv2 reads an AVIF base colour; the port refuses it rather than drop
    it (TIFF and JPEG 2000 ones, read since, are in test_torch_tiff.py and
    test_torch_jp2.py)."""
    avif = cv2.imencode(".avif", F.photo(64, 64, 1))[1].tobytes()
    path = _glb_with_image(tmp_path, avif)
    assert JMesh.load(path, resize=False).albedo.shape == (64, 64, 3)
    with pytest.raises(NotImplementedError, match="AVIF"):
        TMesh.load(path, resize=False)


# ------------------------------------------------------------------ load_rgba

@pytest.mark.parametrize("name", [n for n in IMAGES if DIGESTS[n]["unchanged"]["shape"][-1:] == [4]])
def test_load_rgba_of_a_four_channel_fixture_matches_jax(name):
    path = str(IMAGE_FIXTURES / name)
    ref = jproc.load_rgba(path, size=48)
    got = tproc.load_rgba(path, size=48, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (48, 48, 4)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture
def u2net_at_64(monkeypatch):
    """Both packages' U2Net run at 64^2 in place of rembg's 320^2 (the
    network is the same at any multiple of 32; the matte's steps around it
    are what this file holds, 35 times)."""
    import functools

    from dreamgaussian_tpu.preprocess import u2net as ju2net
    from dreamgaussian_tpu_torch.preprocess import u2net as tu2net

    for mod in (ju2net, tu2net):
        monkeypatch.setattr(mod, "u2net_alpha", functools.partial(mod.u2net_alpha, size=64))


@pytest.mark.parametrize("name", [n for n in IMAGES if DIGESTS[n]["unchanged"]["shape"][-1:] != [4]])
def test_load_rgba_of_an_rgb_or_grey_fixture_matches_jax(name, u2net_files, u2net_at_64):  # noqa: F811
    path = str(IMAGE_FIXTURES / name)
    ref = jproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (48, 48, 4)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


def test_16bit_rgba_keeps_the_references_divide_by_255():
    """The JAX load_rgba divides by 255 whatever the dtype (as upstream
    DreamGaussian does), so a 16-bit RGBA PNG comes out with values up to
    257: a fault of the reference the port keeps, step for step."""
    path = str(IMAGE_FIXTURES / "png_rgba16.png")
    ref, got = jproc.load_rgba(path), tproc.load_rgba(path, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert 200 < got.max() <= 257.0 and got.shape == (61, 83, 4)


@pytest.mark.parametrize("name", ["png_grey16.png", "pnm_p6_16.ppm"])
def test_16bit_rgb_without_weights_raises_as_jax(monkeypatch, name):
    """cv2.grabCut takes 8UC3 only: the JAX package raises, and so does the port."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = str(IMAGE_FIXTURES / name)
    with pytest.raises(cv2.error):
        jproc.load_rgba(path)
    with pytest.raises(ValueError, match="8-bit"):
        tproc.load_rgba(path, device="cpu")


# ------------------------------------------------------------------ refusals

REFUSED = {"SGILog": ".tiff", "JPEG 2000": ".jp2", "JPEG 2000 codestream": ".jp2", "AVIF": ".avif",
           "Radiance HDR": ".hdr", "PFM": ".pfm", "Sun raster": ".ras"}
READ_NOW = ("SGILog", "Radiance HDR", "PFM", "Sun raster")


@pytest.mark.parametrize("kind", list(REFUSED))
def test_formats_cv2_reads_and_the_port_does_not_are_refused_by_name(tmp_path, monkeypatch, kind):
    """AVIF and JPEG 2000 Part 2 stay refused by name. SGILog, Radiance HDR,
    PFM and Sun raster, once refused here, now read as cv2.imread reads
    them under both flags, and ``load_rgba`` of them goes as the JAX
    package's does: a float image refused by GrabCut on both sides (cv2.error,
    the port's ValueError), a Sun raster matted by GrabCut (IoU as in
    test_torch_grabcut.py)."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    # a Sun raster of a scene GrabCut mattes (test_torch_grabcut.py's)
    img = scene("disc", 64, 64, 2)[..., ::-1].copy() if kind == "Sun raster" else F.photo(64, 64, 2)
    ext = REFUSED[kind]
    if kind == "SGILog":                            # a TIFF codec cv2 reads
        data = F.sgilog_tiff(img[..., 0].astype(np.uint16) * 100 + 1000)
    else:
        data = cv2.imencode(ext, img.astype(np.float32) / 255 if ext in (".hdr", ".pfm")
                            else img)[1].tobytes()
    if kind.startswith("JPEG 2000"):        # Part 1 is read in full; a codestream whose Rsiz
        cs = F.j2k_set_rsiz(F.jp2_codestream(data), 0x8000)  # claims Part 2 is refused (cv2 reads it)
        data = cs if kind.endswith("codestream") else F.jp2_rebuild(data, codestream=cs)
    assert _cv2(data, IMREAD_UNCHANGED) is not None          # readable: not a missing file
    path = str(tmp_path / "x.img")
    with open(path, "wb") as fh:
        fh.write(data)
    name = kind.replace(" codestream", "")
    if kind not in READ_NOW:
        for call in (lambda: tproc.read_image(path), lambda: tproc.read_image(path, IMREAD_COLOR),
                     lambda: tproc.load_rgba(path, device="cpu")):
            with pytest.raises(NotImplementedError, match=name):
                call()
        return
    for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
        want = cv2.imread(path, f)
        want = want[..., ::-1] if want is not None and want.ndim == 3 else want
        if want is None:
            with pytest.raises(ValueError, match=name):
                tproc.read_image(path, f)
            continue
        got = tproc.read_image(path, f)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))
    if kind == "Sun raster":
        cv2.setRNGSeed(0)
        ref, got = jproc.load_rgba(path, size=32), tproc.load_rgba(path, size=32, device="cpu")
        assert got.shape == ref.shape == (32, 32, 4)
        assert iou((got[..., 3] * 255).astype(np.uint8), (ref[..., 3] * 255).astype(np.uint8)) >= 0.98
        return
    with pytest.raises(cv2.error):
        jproc.load_rgba(path)
    with pytest.raises(ValueError, match="8-bit"):
        tproc.load_rgba(path, device="cpu")


def test_exr_is_a_missing_file_on_both_sides(tmp_path):
    """OpenEXR is not in this cv2 build: cv2.imread returns None, and both
    sides raise FileNotFoundError."""
    path = str(tmp_path / "x.exr")
    with open(path, "wb") as fh:
        fh.write(b"\x76\x2f\x31\x01\x02\0\0\0" + bytes(64))
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    for load in (jproc.load_rgba, lambda p: tproc.load_rgba(p, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load(path)


# ------------------------------------------------------------------ seeded files

SIZES = [(1, 1), (17, 33), (255, 129)]
WEBP_LOSSLESS = {"rgb": dict(lossless=True), "rgba": dict(lossless=True),
                 "fast": dict(lossless=True, quality=0, method=0),
                 "best": dict(lossless=True, quality=90, method=6),
                 "exact": dict(lossless=True, exact=True)}
WEBP_LOSSY = {"q10": dict(quality=10), "q50": dict(quality=50), "q95": dict(quality=95),
              "m0": dict(quality=75, method=0), "m6": dict(quality=75, method=6),
              "rgba": dict(quality=70), "rgba_aq30": dict(quality=70, alpha_quality=30)}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", list(WEBP_LOSSLESS))
def test_pillow_lossless_webps_read_bit_for_bit(variant, size):
    img = F.photo(*size, seed=size[0] * size[1], channels=4 if variant in ("rgba", "exact") else 3)
    _same_as_cv2(F.webp(img, **WEBP_LOSSLESS[variant]))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", list(WEBP_LOSSY))
def test_pillow_lossy_webps_read_bit_for_bit(variant, size):
    img = F.photo(*size, seed=size[0] + size[1], channels=4 if variant.startswith("rgba") else 3)
    _same_as_cv2(F.webp(img, **WEBP_LOSSY[variant]))


REWRITES = {"simple": dict(simple=1, level=20, sharpness=0),
            "simple_sharp": dict(simple=1, level=63, sharpness=7),
            "normal_sharp": dict(simple=0, level=45, sharpness=4),
            "partitions2": dict(partitions=2), "partitions8": dict(partitions=8, simple=1, level=9,
                                                                    sharpness=1)}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", list(REWRITES))
def test_rewritten_vp8_filters_and_partitions_read_bit_for_bit(variant, size):
    _same_as_cv2(F.vp8_rewrite(F.webp(F.photo(*size, seed=9), quality=60), **REWRITES[variant]))


@pytest.mark.parametrize("method", [0, 1, 2, 3])
@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "lossless"])
def test_alph_chunks_read_bit_for_bit(method, compressed):
    _same_as_cv2(F.webp_with_alph(F.photo(37, 45, seed=method, channels=4), method, compressed))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("fmt", ["jpeg", "png", "webp"])
def test_exif_orientation_applies_under_imread_color_only(fmt, orientation):
    img, ex = F.photo(13, 22, seed=orientation), F.exif_orientation(orientation)
    data = {"jpeg": lambda: F.jpeg_with_exif(cv2.imencode(".jpg", img)[1].tobytes(), ex),
            "png": lambda: F.png(img, 8, 2, exif=ex),
            "webp": lambda: F.webp_with_exif(F.webp(img, lossless=True), ex)}[fmt]()
    _same_as_cv2(data)
    assert decode_image(data, IMREAD_UNCHANGED).shape[:2] == (13, 22)


PNG_CASES = {
    "palette1": (1, 3), "palette2": (2, 3), "palette4": (4, 3), "palette8": (8, 3),
    "grey1": (1, 0), "grey2": (2, 0), "grey4": (4, 0), "grey8": (8, 0), "grey16": (16, 0),
    "rgb8": (8, 2), "rgb16": (16, 2), "ga8": (8, 4), "ga16": (16, 4), "rgba8": (8, 6),
    "rgba16": (16, 6)}
# tRNS only where the colour type has no alpha channel.
PNG_PARAMS = [(case, interlace, trns) for case in PNG_CASES for interlace in (False, True)
              for trns in (False, True) if not (trns and PNG_CASES[case][1] in (4, 6))]


@pytest.mark.parametrize("size", [(1, 1), (19, 27), (255, 129)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case,interlace,trns", PNG_PARAMS,
                         ids=[f"{c}{'-adam7' if i else ''}{'-trns' if t else ''}"
                              for c, i, t in PNG_PARAMS])
def test_seeded_pngs_read_bit_for_bit(case, interlace, trns, size):
    depth, ctype = PNG_CASES[case]
    rng = np.random.default_rng(depth * 10 + ctype + size[0])
    h, w = size
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (h, w, c))
    samples[0, :3] = samples[-1, -1]                  # pixels equal to the tRNS key
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    tr = None
    if trns:
        tr = (bytes(rng.integers(0, 256, (1 << depth) - 1, dtype=np.uint8)) if ctype == 3
              else struct.pack(">" + "H" * c, *map(int, samples[-1, -1])))
    _same_as_cv2(F.png(samples, depth, ctype, palette, tr, interlace, seed=depth))


RESIZES = {"2x2": ((40, 60), (20, 30)), "3x4": ((36, 48), (12, 12)), "shrink": ((61, 83), (48, 48)),
           "enlarge": ((17, 23), (64, 64)), "mixed": ((61, 23), (32, 48)),
           "one_pixel": ((1, 1), (5, 3))}


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_area_on_uint16_is_cv2s(case):
    """OpenCV's INTER_AREA on 16-bit images (the integer and general
    shrinks as on 8-bit, the enlarging side in float32), bit for bit."""
    (h, w), (oh, ow) = RESIZES[case]
    img = np.random.default_rng(h * w).integers(0, 65536, (h, w, 4)).astype(np.uint16)
    got = resize_area(img, oh, ow)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))
