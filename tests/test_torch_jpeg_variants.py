"""The port's arithmetic-coded and lossless JPEG decoding (``utils/jpeg.py``
with ``csrc/image_tools.cpp``) against cv2 (OpenCV 5.0 with libjpeg-turbo
3.1), and what reads through it against the JAX package: ``load_rgba`` and
the textures of ``Mesh.load``.

The files are ``scripts/port_make_jpeg_variant_fixtures.py``'s, from its
own encoders (cv2 writes neither process): lossless files of every
predictor, point transform, restart interval, component layout and colour
marker, arithmetic-coded sequential and progressive files with and without
a DAC segment and restart markers, files cut off, and the processes and
settings cv2 refuses. cv2 is the specification: where it and T.81 differ
(a lossless file without a JFIF or Adobe marker is RGB whatever its
component ids; 2- to 7-bit lossless samples are read as stored; a
lossless restart interval of part of an MCU row, 12- and 16-bit samples,
SOF5-SOF8, SOF11 and SOF13-SOF15 are None), the tests follow cv2.

Tolerance: every decode equal to cv2's bit for bit (dtype, shape, values;
channels in RGB order) under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``:
``read_image`` against the stored digests of ``cv2.imread`` and against
``cv2.imread`` itself, ``decode_image`` against ``cv2.imdecode`` for the
files that are whole; where cv2 gives None the port raises ValueError
naming the format. Cut and damaged copies of the files against
``cv2.imread`` of them. ``load_rgba`` with U2Net equal to the JAX
package's (RGB exactly, alpha within 1/255), through GrabCut by IoU;
``Mesh.load`` albedos equal exactly."""

import hashlib
import json

import cv2
import numpy as np
import pytest

from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu.meshing.mesh import Mesh as JMesh
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.meshing.mesh import Mesh as TMesh
from dreamgaussian_tpu_torch.utils.imread import (IMREAD_COLOR, IMREAD_UNCHANGED, decode_image,
                                                  read_image)
from dreamgaussian_tpu_torch.utils.jpeg import read_coefficients
from test_torch_process import u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import JPEG_FIXTURES, JPEG_VARIANT_FIXTURES, iou

DIGESTS = json.loads((JPEG_VARIANT_FIXTURES / "decodes.json").read_text())
FLAGS = {"unchanged": IMREAD_UNCHANGED, "color": IMREAD_COLOR}
CUT = sorted(n for n in DIGESTS if "_cut_" in n)
WHOLE = sorted(n for n in DIGESTS if "_cut_" not in n and n != "ar_prog_unrefined.jpg")
# Whole files of each kind that the damage test cuts and alters.
DAMAGED = ["ar_seq_420.jpg", "ar_seq_grey.jpg", "ar_seq_restart.jpg", "ar_seq_dac.jpg",
           "ar_prog_420.jpg", "ar_prog_restart_dac.jpg", "ar_prog_grey.jpg",
           "ll_grey_psv4.jpg", "ll_grey_6bit.jpg", "ll_rgb_restart.jpg",
           "ll_rgb_scans_restart.jpg", "ll_rgb_subsampled.jpg", "ll_cmyk.jpg"]
IOU_MIN = 0.98


def _rgb(img):
    return img if img is None or img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _digest(img) -> list:
    return [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]


def _same(read, want):
    """``read()`` equals cv2's ``want``, or raises ValueError naming the
    format where cv2 gave None."""
    if want is None:
        with pytest.raises(ValueError, match="JPEG"):
            read()
        return
    got = read()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_reads_as_cv2_read_it(name, key):
    """read_image against the stored digest of cv2.imread's decode (and its
    .npy), and against cv2.imread of the file here."""
    path = JPEG_VARIANT_FIXTURES / name
    want = DIGESTS[name] if key == "unchanged" else DIGESTS[name]["color"]
    if want is None or want["sha256"] is None:
        assert cv2.imread(str(path), FLAGS[key]) is None
        with pytest.raises(ValueError, match="JPEG"):
            read_image(str(path), FLAGS[key])
        return
    got = read_image(str(path), FLAGS[key])
    assert _digest(got) == [want["shape"], want["sha256"]]
    npy = path.with_suffix(".npy")
    if key == "unchanged" and npy.exists():
        np.testing.assert_array_equal(got, np.load(npy))
    np.testing.assert_array_equal(got, _rgb(cv2.imread(str(path), FLAGS[key])))


@pytest.mark.parametrize("name", WHOLE)
def test_whole_fixture_decodes_from_memory_as_cv2_imdecode(name):
    """decode_image without a name against cv2.imdecode, both flags."""
    data = (JPEG_VARIANT_FIXTURES / name).read_bytes()
    for flags in FLAGS.values():
        want = _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), flags))
        _same(lambda: decode_image(data, flags), want)


def test_fixture_directory_stays_small():
    assert sum(f.stat().st_size for f in JPEG_VARIANT_FIXTURES.iterdir()) < 1 << 20


def test_every_process_and_refusal_is_among_the_fixtures():
    """The fixtures cover what the decoder reads and cv2's refusals."""
    none = {n for n, d in DIGESTS.items() if d["sha256"] is None}
    for process in ("ll_grey_psv", "ll_grey_pt", "ll_rgb_", "ll_cut_", "ar_seq_", "ar_prog_",
                    "ar_cut_", "ar_rewritten_"):
        assert any(n.startswith(process) and n not in none for n in DIGESTS), process
    for refused in ("sof5", "sof6", "sof7", "sof8", "sof13", "sof14", "sof15", "sof1_12bit",
                    "ll_sof11", "ll_grey_12bit", "ll_grey_16bit", "ll_rgb_jfif",
                    "ll_rgb_adobe1", "ll_ycck", "ll_two_components", "ll_grey_partial_restart",
                    "ar_dac_l_over_u", "ar_rewritten_base_sof10"):
        assert refused + ".jpg" in none, refused
    assert {f"ll_grey_psv{p}.jpg" for p in range(1, 8)} <= set(DIGESTS)


def test_transcodes_hold_the_huffman_files_coefficients():
    """photo_512_arith.jpg (progressive) and photo_1024x768_arith.jpg
    (sequential) are the Huffman photos' quantised coefficients: the
    arithmetic decoder gives every coefficient back, and the pixels are
    cv2's decode of the Huffman file."""
    for name, source in (("photo_512_arith.jpg", "photo_512.jpg"),
                         ("photo_1024x768_arith.jpg", "photo_1024x768.jpg")):
        got = read_coefficients((JPEG_VARIANT_FIXTURES / name).read_bytes())
        want = read_coefficients((JPEG_FIXTURES / source).read_bytes())
        assert got["size"] == want["size"] and got["components"] == want["components"]
        for a, b in zip(got["coefficients"], want["coefficients"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(read_image(str(JPEG_VARIANT_FIXTURES / name)),
                                      _rgb(cv2.imread(str(JPEG_FIXTURES / source))))


@pytest.mark.parametrize("name", DAMAGED)
def test_cut_and_damaged_files_read_as_cv2_imread_reads_them(tmp_path, name):
    """Each file cut at 12 points and with 12 sets of changed bytes: the
    out-of-data rules (an arithmetic scan reads zeros on, a lossless one
    gives zero differences by the first-row predictor), restart resync,
    bad arithmetic codes and overflows, and every marker or header the
    damage makes, against cv2.imread of the file under both flags."""
    data = (JPEG_VARIANT_FIXTURES / name).read_bytes()
    rng = np.random.default_rng(sum(data[:64]))
    sos = data.index(b"\xff\xda")
    cases = [data[:int(n)] for n in np.linspace(sos, len(data) - 1, 12)]
    for _ in range(12):
        bad = bytearray(data)
        for at in rng.integers(sos, len(data), int(rng.integers(1, 4))):
            bad[at] = int(rng.integers(0, 256))
        cases.append(bytes(bad))
    path = tmp_path / "damaged.jpg"
    for k, case in enumerate(cases):
        path.write_bytes(case)
        for flags in FLAGS.values():
            _same(lambda: read_image(str(path), flags), _rgb(cv2.imread(str(path), flags)))


@pytest.mark.parametrize("name", ["photo_110x150_arith.jpg", "photo_110x150_lossless.jpg"])
def test_load_rgba_of_an_arithmetic_or_lossless_jpeg_matches_jax(u2net_files, name):  # noqa: F811
    path = str(JPEG_VARIANT_FIXTURES / name)
    ref = jproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.shape == (64, 64, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


@pytest.mark.parametrize("name", ["disc_arith.jpg", "disc_lossless.jpg"])
def test_load_rgba_through_grabcut_matches_jax(monkeypatch, name):
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = str(JPEG_VARIANT_FIXTURES / name)
    cv2.setRNGSeed(0)
    ref = jproc.load_rgba(path, size=64)
    got = tproc.load_rgba(path, size=64, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (64, 64, 4)
    assert iou((got[..., 3] * 255).astype(np.uint8), (ref[..., 3] * 255).astype(np.uint8)) >= IOU_MIN


@pytest.mark.parametrize("tex", ["texture_arith.jpg", "ll_rgb_subsampled.jpg", "ll_cmyk.jpg"])
def test_textured_obj_matches_jax(tmp_path, tex):
    """An OBJ whose map_Kd is arithmetic-coded or lossless."""
    (tmp_path / tex).write_bytes((JPEG_VARIANT_FIXTURES / tex).read_bytes())
    (tmp_path / "m.mtl").write_text(f"newmtl m\nmap_Kd {tex}\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "vt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    ref = JMesh.load(str(tmp_path / "m.obj"), resize=False).albedo
    got = TMesh.load(str(tmp_path / "m.obj"), resize=False).albedo
    assert ref is not None and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tex", ["ll_rgb_jfif.jpg", "ll_grey_pt2.jpg"])
def test_lossless_texture_cv2_will_not_convert_raises_on_both_sides(tmp_path, tex):
    """cv2 gives None for a lossless YCbCr file, and for a grey one under
    IMREAD_COLOR: the JAX loader raises on the OBJ's texture, and so does
    the port (ValueError naming it)."""
    (tmp_path / "t.jpg").write_bytes((JPEG_VARIANT_FIXTURES / tex).read_bytes())
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd t.jpg\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "vt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    with pytest.raises(Exception):
        JMesh.load(str(tmp_path / "m.obj"), resize=False)
    with pytest.raises(ValueError, match="lossless JPEG in"):
        TMesh.load(str(tmp_path / "m.obj"), resize=False)


def _segment(data: bytes, code: int, nth: int = 0) -> tuple[int, int]:
    """(offset, length field) of the ``nth`` segment of marker ``code``."""
    at = -1
    for _ in range(nth + 1):
        at = data.index(bytes([0xFF, code]), at + 1)
    return at, int.from_bytes(data[at + 2:at + 4], "big")


def _edit(data: bytes, rule: str) -> bytes:
    if rule.startswith("dqt") and b"\xff\xdb" not in data:     # a lossless file: one DQT
        data = data[:2] + bytes.fromhex("ffdb004300") + b"\x01" * 64 + data[2:]
    out = bytearray(data)
    sof = next(i for i in range(len(data) - 1)
               if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2, 0xC9, 0xCA, 0xC3))
    if rule == "mcu_of_18_blocks":               # luma 4x4 beside two 1x1 chroma
        out[sof + 11] = 0x44
    elif rule == "scan_out_of_frame_order":
        sos, _ = _segment(data, 0xDA)
        out[sos + 5], out[sos + 7] = data[sos + 7], data[sos + 5]
    elif rule == "frame_id_twice":              # the scan's second id then matches slot 1
        out[sof + 13] = data[sof + 10]
        sos, _ = _segment(data, 0xDA)
        out[sos + 7] = data[sof + 10]
    elif rule == "dri_length":
        return data[:2] + bytes.fromhex("ffdd000500020000") + data[2:]
    elif rule == "dqt_table_4":
        at, _ = _segment(data, 0xDB)
        out[at + 4] = (data[at + 4] & 0xF0) | 4
    elif rule == "dqt_short":
        at, length = _segment(data, 0xDB)
        out[at + 2:at + 4] = (length - 10).to_bytes(2, "big")
    elif rule == "quant_table_missing":
        out[sof + 12] = 3                         # the first component's table: none
    elif rule == "huffman_tables_dropped":      # libjpeg-turbo's Annex K tables, sequential
        while b"\xff\xc4" in out:
            at, length = _segment(bytes(out), 0xC4)
            out = out[:at] + out[at + 2 + length:]
    return bytes(out)


@pytest.mark.parametrize("rule", ["mcu_of_18_blocks", "scan_out_of_frame_order",
                                  "frame_id_twice", "dri_length", "dqt_table_4", "dqt_short",
                                  "quant_table_missing", "huffman_tables_dropped"])
@pytest.mark.parametrize("name", ["port_jpeg/small_q95.jpg", "port_jpeg/small_progressive.jpg",
                                  "ar_seq_420.jpg", "ar_prog_420.jpg", "ll_rgb_ids123.jpg"])
def test_header_rules_read_as_cv2_reads_them(name, rule):
    """Header rules of libjpeg-turbo's marker reader that damaged files
    showed (``scripts/port_jpeg_damage_sweep.py``): an interleaved MCU of
    more than 10 blocks, scan components out of the frame's order or named
    twice (get_sos's slot rule), a DRI or DQT of the wrong length, a table
    number over 3, a quantisation table no DQT defined (None), and missing
    Huffman tables (Annex K's in a sequential file, None in a progressive
    or lossless one): against cv2.imdecode under both flags."""
    folder = JPEG_FIXTURES.parent if "/" in name else JPEG_VARIANT_FIXTURES
    data = _edit((folder / name).read_bytes(), rule)
    for flags in FLAGS.values():
        want = _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), flags))
        _same(lambda: decode_image(data, flags), want)
