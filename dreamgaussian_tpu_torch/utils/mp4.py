"""H.264 MP4 turntables, the port's own (no ffmpeg, imageio or cv2 on the
card machine).

``cli/render.py`` writes ``.mp4`` through ``write_mp4``, where the JAX CLI
calls ``imageio.mimwrite(path, frames, fps=fps)``, which imageio-ffmpeg turns
into libx264 at ``-crf 25`` and yuv420p. Here:

- ``rgb_to_yuv420p``: BT.601 limited range (Y 16-235, Cb and Cr 16-240),
  the matrix swscale applies to imageio's rgb24 -> yuv420p, with chroma
  taken from the mean of each 2x2 block; ``yuv420p_to_rgb`` inverts it
  (chroma repeated over its 2x2 block);
- imageio's ``macro_block_size=16``: a size that is not a multiple of 16 is
  scaled up to the next multiples (``utils/resize.py`` ``resize_linear``;
  swscale's default is bicubic) with imageio-ffmpeg's warning line;
- ``csrc/h264_intra.cpp`` encodes every frame as an IDR picture of
  Constrained Baseline at the fixed ``QP`` with the loop filter off, and
  returns its reconstruction, which is what a decoder outputs;
- the ISO BMFF file: ``ftyp`` (isom), ``moov`` before ``mdat``, one video
  track whose ``avc1`` sample entry carries the SPS and PPS in ``avcC``,
  one sample per frame of 4-byte length-prefixed NAL units, every sample a
  sync sample (no ``stss``).

``read_mp4`` walks that box tree back (sample sizes, timescale and
durations, the SPS's picture size); it is not a decoder.
"""

from __future__ import annotations

import ctypes
import struct
import sys

import numpy as np

from .. import native
from .resize import resize_linear

QP = 25                 # imageio's quality=5 gives libx264 -crf int((1 - 5 / 10) * 51)
MACRO_BLOCK_SIZE = 16
MOVIE_TIMESCALE = 1000
SAMPLE_TICKS = 1000     # a frame's duration: the track counts fps * 1000 ticks a second

# BT.601 luma weights and the limited-range scales (219 and 224 levels of 255).
_KR, _KB = 0.299, 0.114
_RGB_TO_YUV = np.array([
    [_KR, 1 - _KR - _KB, _KB],
    [-_KR / (2 - 2 * _KB), -(1 - _KR - _KB) / (2 - 2 * _KB), 0.5],
    [0.5, -(1 - _KR - _KB) / (2 - 2 * _KR), -_KB / (2 - 2 * _KR)],
]) * np.array([[219.0], [224.0], [224.0]]) / 255.0
_YUV_TO_RGB = np.linalg.inv(_RGB_TO_YUV)

# Table A-1 by level_idc: MaxMBPS, MaxFS, MaxDpbMbs, MaxBR and MaxCPB (in
# 1200 bits of a NAL HRD, Baseline).
_LEVELS = (
    (10, 1485, 99, 396, 64, 175), (11, 3000, 396, 900, 192, 500),
    (12, 6000, 396, 2376, 384, 1000), (13, 11880, 396, 2376, 768, 2000),
    (20, 11880, 396, 2376, 2000, 2000), (21, 19800, 792, 4752, 4000, 4000),
    (22, 20250, 1620, 8100, 4000, 4000), (30, 40500, 1620, 8100, 10000, 10000),
    (31, 108000, 3600, 18000, 14000, 14000), (32, 216000, 5120, 20480, 20000, 20000),
    (40, 245760, 8192, 32768, 20000, 25000), (41, 245760, 8192, 32768, 50000, 62500),
    (42, 522240, 8704, 34816, 50000, 62500), (50, 589824, 22080, 110400, 135000, 135000),
    (51, 983040, 36864, 184320, 240000, 240000), (52, 2073600, 36864, 184320, 240000, 240000),
    (60, 4177920, 139264, 696320, 240000, 240000), (61, 8355840, 139264, 696320, 480000, 240000),
    (62, 16711680, 139264, 696320, 800000, 240000),
)


def rgb_to_yuv420p(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint8 RGB [H, W, 3] (H and W even) -> uint8 Y [H, W], Cb and Cr [H/2, W/2]."""
    h, w = rgb.shape[:2]
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or h % 2 or w % 2:
        raise ValueError(f"expected uint8 RGB of even size, got {rgb.dtype} {rgb.shape}")
    f = rgb.astype(np.float64)
    y = f @ _RGB_TO_YUV[0] + 16.0
    mean = f.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
    cb = mean @ _RGB_TO_YUV[1] + 128.0
    cr = mean @ _RGB_TO_YUV[2] + 128.0
    return tuple(np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8) for p in (y, cb, cr))


def yuv420p_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The inverse of ``rgb_to_yuv420p`` on planes of any leading shape:
    uint8 [..., H, W, 3]."""
    up = lambda c: np.repeat(np.repeat(c, 2, axis=-2), 2, axis=-1).astype(np.float64) - 128.0
    yuv = np.stack([y.astype(np.float64) - 16.0, up(cb), up(cr)], -1)
    return np.clip(np.floor(yuv @ _YUV_TO_RGB.T + 0.5), 0, 255).astype(np.uint8)


def fit_macro_blocks(frames: list) -> list:
    """imageio-ffmpeg's ``macro_block_size=16``: frames whose size is not a
    multiple of 16 are scaled up to the next multiples, with its warning."""
    h, w = frames[0].shape[:2]
    out_w, out_h = (-(-n // MACRO_BLOCK_SIZE) * MACRO_BLOCK_SIZE for n in (w, h))
    if (out_w, out_h) == (w, h):
        return frames
    print(f"IMAGEIO FFMPEG_WRITER WARNING: input image is not divisible by macro_block_size="
          f"{MACRO_BLOCK_SIZE}, resizing from {(w, h)} to {(out_w, out_h)} to ensure video "
          "compatibility with most codecs and players. To prevent resizing, make your input "
          "image divisible by the macro_block_size or set the macro_block_size to 1 (risking "
          "incompatibility).", file=sys.stderr)
    return [np.clip(np.floor(resize_linear(f.astype(np.float32), out_h, out_w) + 0.5), 0, 255)
            .astype(np.uint8) for f in frames]


def _call(fn, *args) -> None:
    msg = ctypes.create_string_buffer(256)
    if fn(*args, msg, len(msg)) != 0:
        raise RuntimeError(f"H.264 encoder: {msg.value.decode()}")


def level_idc(width: int, height: int, fps: float, sizes: np.ndarray) -> int:
    """The lowest level_idc of Table A-1 whose frame size, macroblock rate,
    picture buffer, bit rate and CPB size hold the stream (the highest
    level where none carries the bit rate)."""
    mbs, side = width * height // 256, max(width, height) // 16
    rate = 8 * float(sizes.sum()) * fps / len(sizes)
    sized = [row for row in _LEVELS
             if mbs <= row[2] and side ** 2 <= 8 * row[2] and mbs * fps <= row[1] and mbs <= row[3]]
    if not sized:
        raise ValueError(f"{width}x{height} at {fps} fps exceeds every level of H.264")
    return next((row[0] for row in sized
                 if rate <= 1200 * row[4] and 8 * int(sizes.max()) <= 1200 * row[5]), sized[-1][0])


def encode_h264(frames: list, fps: float, qp: int = QP):
    """uint8 RGB frames -> (SPS, PPS, each frame's slice NAL unit, the
    reconstruction (Y, Cb, Cr) as [N, H, W] and [N, H/2, W/2], I_PCM
    macroblocks per frame)."""
    planes = [rgb_to_yuv420p(f) for f in fit_macro_blocks(frames)]
    y, cb, cr = (np.ascontiguousarray(np.stack(p)) for p in zip(*planes))
    n, h, w = y.shape
    rec = tuple(np.empty_like(p) for p in (y, cb, cr))
    cap = n * ((w // 16) * (h // 16) * 600 + 1024)
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(n, np.int64)
    pcm = np.zeros(n, np.int32)
    lib = native.h264_intra()
    _call(lib.dg_h264_encode, y.ctypes.data, cb.ctypes.data, cr.ctypes.data, w, h, n, qp,
          rec[0].ctypes.data, rec[1].ctypes.data, rec[2].ctypes.data, out.ctypes.data, cap,
          sizes.ctypes.data, pcm.ctypes.data)
    ends = np.cumsum(sizes)
    slices = [out[e - s:e].tobytes() for s, e in zip(sizes, ends)]
    head = np.empty(256, np.uint8)
    lens = np.zeros(2, np.int32)
    _call(lib.dg_h264_headers, w, h, level_idc(w, h, fps, sizes), qp, head.ctypes.data, head.size,
          lens.ctypes.data)
    sps, pps = head[:lens[0]].tobytes(), head[lens[0]:lens[0] + lens[1]].tobytes()
    return sps, pps, slices, rec, pcm


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(w: int, h: int, sps: bytes, pps: bytes, sizes: list, fps: float, offset: int) -> bytes:
    n = len(sizes)
    timescale = int(round(fps * SAMPLE_TICKS))
    movie_dur = int(round(n * MOVIE_TIMESCALE / fps))
    avcc = _box(b"avcC", bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]),
                struct.pack(">H", len(sps)), sps, bytes([1]), struct.pack(">H", len(pps)), pps)
    avc1 = _box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16), struct.pack(">HH", w, h),
                struct.pack(">III", 0x480000, 0x480000, 0), struct.pack(">H", 1),
                bytes([15]) + b"dreamgaussian".ljust(31, b"\0"), struct.pack(">Hh", 0x18, -1),
                avcc)
    stbl = _box(b"stbl",
                _full(b"stsd", 0, 0, struct.pack(">I", 1), avc1),
                _full(b"stts", 0, 0, struct.pack(">III", 1, n, SAMPLE_TICKS)),
                _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
                _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
                _full(b"stco", 0, 0, struct.pack(">II", 1, offset)))
    minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1))),
                stbl)
    mdia = _box(b"mdia",
                _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, n * SAMPLE_TICKS, 0x55C4,
                                                 0)),
                _full(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", bytes(12), b"VideoHandler\0"),
                minf)
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_dur), bytes(8),
                 struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX, struct.pack(">II", w << 16, h << 16))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, MOVIE_TIMESCALE, movie_dur, 0x10000,
                                            0x100), bytes(10), _MATRIX, bytes(24),
                 struct.pack(">I", 2))
    return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))


def encode_mp4(frames: list, fps: float) -> tuple[bytes, tuple]:
    """uint8 RGB frames [H, W, 3] -> (the MP4 file's bytes, the decoded
    planes (Y, Cb, Cr) of every frame)."""
    if not frames or any(f.shape != frames[0].shape for f in frames):
        raise ValueError("expected one or more frames of one size")
    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    sps, pps, slices, rec, _ = encode_h264(frames, fps)
    return mux_mp4(sps, pps, slices, fps), rec


def mux_mp4(sps: bytes, pps: bytes, slices: list, fps: float) -> bytes:
    """The MP4 file of one IDR slice NAL unit per frame."""
    w, h = _sps_size(sps)
    samples = [struct.pack(">I", len(s)) + s for s in slices]
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2avc1mp41")
    payload = sum(len(s) for s in samples)
    large = payload + 8 >= 2 ** 32
    mdat_head = (struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", payload + 16) if large else
                 struct.pack(">I", payload + 8) + b"mdat")
    sizes = [len(s) for s in samples]
    # The one chunk starts right after moov, so its offset fits stco's 32
    # bits; past 4 GiB it is mdat's size that takes 64.
    head = len(ftyp) + len(_moov(w, h, sps, pps, sizes, fps, 0)) + len(mdat_head)
    moov = _moov(w, h, sps, pps, sizes, fps, head)
    return b"".join([ftyp, moov, mdat_head, *samples])


def write_mp4(path: str, frames: list, fps: float) -> tuple:
    """Writes ``frames`` as an H.264 MP4 at ``path``; returns the decoded planes."""
    data, rec = encode_mp4(frames, fps)
    with open(path, "wb") as f:
        f.write(data)
    return rec


# ---------------------------------------------------------------- reading

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"}


def _boxes(data: bytes, start: int, end: int):
    """(kind, payload start, payload end) of each box in data[start:end]."""
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[at + 8:at + 16])[0], 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            raise ValueError(f"box {kind!r} at {at} runs past its parent")
        yield kind, at + head, at + size
        at += size


class _BitReader:
    def __init__(self, rbsp: bytes):
        self.bits = "".join(f"{b:08b}" for b in rbsp)
        self.at = 0

    def u(self, n: int) -> int:
        v = int(self.bits[self.at:self.at + n] or "0", 2)
        self.at += n
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bits[self.at + zeros] == "0":
            zeros += 1
        self.at += zeros
        return self.u(zeros + 1) - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _unescape(nal: bytes) -> bytes:
    """The RBSP of a NAL unit's payload: emulation prevention bytes removed."""
    out, zeros = bytearray(), 0
    for b in nal:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _sps_size(sps: bytes) -> tuple[int, int]:
    """(width, height) of an SPS NAL unit of the Baseline, Main or Extended
    profiles, after its frame cropping."""
    r = _BitReader(_unescape(sps[1:]))
    profile = r.u(8)
    r.u(16)
    r.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        raise ValueError(f"SPS of profile_idc {profile} is not read")
    r.ue()
    poc = r.ue()
    if poc == 0:
        r.ue()
    elif poc == 1:
        r.u(1), r.se(), r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue(), r.u(1)
    wmb, hmap = r.ue() + 1, r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)
    r.u(1)
    crop = [r.ue() for _ in range(4)] if r.u(1) else [0, 0, 0, 0]
    rows = 2 - frame_mbs_only
    return (16 * wmb - 2 * (crop[0] + crop[1]),
            16 * hmap * rows - 2 * rows * (crop[2] + crop[3]))


def read_mp4(path: str) -> dict:
    """The box tree of an MP4 with one AVC video track in one chunk:
    ``brand``, ``timescale``, ``durations`` and ``sample_sizes`` (one per
    sample), ``nal_types`` (per sample), ``sps``, ``pps``, ``profile_idc``,
    ``level_idc``, the SPS's ``width`` and ``height``, the track header's
    ``track_size``, and ``mdat_before_moov``."""
    with open(path, "rb") as f:
        data = f.read()
    u32 = lambda at: int.from_bytes(data[at:at + 4], "big")
    u16 = lambda at: int.from_bytes(data[at:at + 2], "big")
    top = {k: (s, e) for k, s, e in _boxes(data, 0, len(data))}
    found: dict = {}

    def walk(start, end):
        for kind, s, e in _boxes(data, start, end):
            if kind in _CONTAINERS:
                walk(s, e)
            else:
                found.setdefault(kind, s)   # payload start, past the box header

    walk(*top.get(b"moov", (0, 0)))
    for need in (b"ftyp", b"mdat"):
        if need not in top:
            raise ValueError(f"{path}: no {need.decode()} box at the top level")
    for need in (b"tkhd", b"mdhd", b"stsd", b"stts", b"stsz", b"stsc", b"stco"):
        if need not in found:
            raise ValueError(f"{path}: no {need.decode()} box")
    kind, entry, entry_end = next(_boxes(data, found[b"stsd"] + 8, len(data)))
    if kind != b"avc1":
        raise ValueError(f"{path}: sample entry {kind!r}, not avc1")
    at = {k: s for k, s, _ in _boxes(data, entry + 78, entry_end)}[b"avcC"]
    length_size = (data[at + 4] & 3) + 1
    sets, at, count = [], at + 6, data[at + 5] & 31
    for group in range(2):                  # the SPSs, then the PPSs
        for _ in range(count):
            sets.append(data[at + 2:at + 2 + u16(at)])
            at += 2 + u16(at)
        if group == 0:
            n_sps, count, at = len(sets), data[at], at + 1
    sps, pps = sets[0], sets[n_sps]
    s = found[b"stts"]
    durations = [d for k in range(u32(s + 4)) for d in [u32(s + 12 + 8 * k)] * u32(s + 8 + 8 * k)]
    s = found[b"stsz"]
    sizes = [u32(s + 12 + 4 * k) if not u32(s + 4) else u32(s + 4) for k in range(u32(s + 8))]
    if u32(found[b"stsc"] + 4) != 1 or u32(found[b"stco"] + 4) != 1:
        raise ValueError(f"{path}: the samples are not one chunk")
    nal_types, at = [], u32(found[b"stco"] + 8)
    for size in sizes:
        types, k = [], at
        while k < at + size:
            types.append(data[k + length_size] & 31)
            k += length_size + int.from_bytes(data[k:k + length_size], "big")
        if k != at + size:
            raise ValueError(f"{path}: a sample's NAL units overrun it")
        nal_types.append(types)
        at += size
    width, height = _sps_size(sps)
    s = found[b"tkhd"]
    return {"brand": data[top[b"ftyp"][0]:top[b"ftyp"][0] + 4],
            "timescale": u32(found[b"mdhd"] + 12), "durations": durations,
            "sample_sizes": sizes, "nal_types": nal_types,
            "profile_idc": sps[1], "level_idc": sps[3], "width": width, "height": height,
            "track_size": (u32(s + 76) >> 16, u32(s + 80) >> 16),
            "mdat_before_moov": top[b"mdat"][0] < top[b"moov"][0]}
