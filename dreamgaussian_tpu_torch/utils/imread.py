"""``read_image``: the port's ``cv2.imread``, on the host (no cv2, no PIL).

The decoder follows the file's leading bytes, as ``cv2.imread`` does, and
the result equals what ``cv2.imread(path, flags)`` returns for
``IMREAD_UNCHANGED`` (-1) and ``IMREAD_COLOR`` (1) — dtype, channel count
and values — with the channels in RGB(A) order:

- PNG (``utils/png.py``), JPEG (``utils/jpeg.py``: Huffman and
  arithmetic coding, sequential, progressive and lossless), WebP
  (``utils/webp.py``), BMP (``utils/bmp.py``), PNM and PAM
  (``utils/pnm.py``), GIF's first frame (``utils/gif.py``), TIFF and
  BigTIFF's first page (``utils/tiff.py``, which follows cv2's own TIFF
  rules: its orientation under both flags, its channel counts, libtiff's
  conversions, SGILog's float XYZ, ThunderScan and 10-, 12- and 14-bit
  samples among them), JPEG 2000 as JP2 files and raw J2K codestreams
  (``utils/jpeg2000.py``, with cv2's own JPEG 2000 rules for depth,
  channels and colour spaces; HTJ2K and Part 2 raise NotImplementedError
  naming them), Radiance HDR (``utils/hdr.py``, float32), PFM
  (``utils/pfm.py``, float32) and Sun raster (``utils/sunras.py``);
- ``IMREAD_COLOR`` gives 3 channels of uint8 (grey repeated, alpha dropped,
  16-bit samples shifted right by 8, float samples converted as cv2
  converts each format's: HDR's times 255, PFM's unscaled) and applies the
  EXIF orientation of a JPEG (APP1), a PNG (``eXIf``) or a WebP
  (``EXIF``), as cv2 does; ``IMREAD_UNCHANGED`` leaves the orientation
  alone;
- AVIF, which cv2 reads and the port does not, raises NotImplementedError
  naming the format; bytes no decoder of cv2 recognises raise
  FileNotFoundError, as the JAX package raises when ``cv2.imread`` returns
  None; a file of a format read here that does not decode (where cv2
  returns None) raises ValueError naming the format (and, for a JPEG, the
  process or setting libjpeg-turbo refuses: hierarchical and lossless
  arithmetic-coded files, lossy samples of other than 8 bits, a lossless
  file that would need a colour conversion).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .bmp import decode_bmp
from .gif import imread_gif
from .hdr import SIGNATURES as HDR_SIGNATURES
from .hdr import decode_hdr
from .jpeg import decode_jpeg
from .jpeg2000 import J2K_SIGNATURE, JP2_SIGNATURE, decode_jpeg2000
from .pfm import decode_pfm
from .png import imread_png
from .pnm import decode_pnm
from .sunras import SIGNATURE as SUNRAS_SIGNATURE
from .sunras import decode_sunras
from .tiff import decode_tiff, orient
from .webp import decode_webp

IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1


def _exif_orientation(exif: bytes | None) -> int:
    """The orientation tag (0x0112) of an EXIF block (a TIFF structure,
    with or without its ``Exif\\0\\0`` prefix); 1 when absent."""
    if not exif:
        return 1
    if exif.startswith(b"Exif\0\0"):
        exif = exif[6:]
    if len(exif) < 8 or exif[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if exif[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "I", exif, 4)[0]
    if ifd + 2 > len(exif):
        return 1
    for k in range(struct.unpack_from(e + "H", exif, ifd)[0]):
        at = ifd + 2 + 12 * k
        if at + 12 > len(exif):
            break
        tag, typ = struct.unpack_from(e + "HH", exif, at)
        if tag == 0x0112 and typ == 3:
            return struct.unpack_from(e + "H", exif, at + 8)[0]
    return 1


def _jpeg_exif(data: bytes) -> bytes | None:
    """The first APP1 ``Exif`` segment of a JPEG, before its first scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\0\0":
            return data[pos + 4:pos + 2 + length]
        pos += 2 + length
    return None


def _color(img: np.ndarray) -> np.ndarray:
    """A decode under IMREAD_UNCHANGED -> IMREAD_COLOR's 3 channels of uint8
    (libpng's strip_16, gray_to_rgb and strip_alpha; libjpeg's and libwebp's
    RGB output; OpenCV's BGRA2BGR for a GIF)."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _is_avif(data: bytes) -> bool:
    return data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis")


def _format(data: bytes) -> str | None:
    """The format of the port's decoders that the leading bytes name, else None."""
    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return "TIFF"
    if data[:1] == b"P" and data[1:2] in b"1234567" and data[2:3].isspace():
        return "PNM"
    if data.startswith(JP2_SIGNATURE) or data.startswith(J2K_SIGNATURE):
        return "JPEG 2000"
    if data.startswith(HDR_SIGNATURES):
        return "Radiance HDR"
    if data[:1] == b"P" and data[1:2] in (b"f", b"F") and data[2:3].isspace():
        return "PFM"
    if data.startswith(SUNRAS_SIGNATURE):
        return "Sun raster"
    return None


def decode_image(data: bytes, flags: int = IMREAD_UNCHANGED, name: str = "") -> np.ndarray:
    """Image bytes -> ``cv2.imdecode(data, flags)``'s array in RGB(A) order
    (with a ``name``, ``cv2.imread(name, flags)``'s: they differ for one
    rare TIFF layout and a one-channel PFM under IMREAD_COLOR). A file of a
    format read here that does not decode (where cv2 returns None for a
    malformed file) raises ValueError naming the format."""
    if flags not in (IMREAD_UNCHANGED, IMREAD_COLOR):
        raise ValueError(f"imread flags {flags}: IMREAD_UNCHANGED (-1) or IMREAD_COLOR (1)")
    fmt = _format(data)
    if fmt is None:
        if not _is_avif(data):
            raise FileNotFoundError(name or "image bytes no decoder recognises")
        raise NotImplementedError(f"{name or 'the image'}: AVIF images are not read by the "
                                  f"port (PNG, JPEG, WebP, BMP, PNM, GIF, TIFF, JPEG 2000, "
                                  f"Radiance HDR, PFM and Sun raster are); convert it to PNG")
    exif = None
    try:
        if fmt == "BMP":
            return decode_bmp(data, flags)
        if fmt == "PNM":
            return decode_pnm(data, flags)
        if fmt == "Radiance HDR":
            return decode_hdr(data, flags)
        if fmt == "PFM":
            return decode_pfm(data, flags, imread=bool(name))
        if fmt == "Sun raster":
            return decode_sunras(data, flags)
        if fmt == "TIFF":
            return decode_tiff(data, flags, imread=bool(name))
        if fmt == "JPEG 2000":
            return decode_jpeg2000(data, flags)
        if fmt == "PNG":
            img, exif = imread_png(data)
        elif fmt == "JPEG":
            img, exif = decode_jpeg(data, flags=flags), _jpeg_exif(data)
        elif fmt == "WebP":
            img, exif = decode_webp(data)
        else:
            img = imread_gif(data)
    except (ValueError, IndexError, struct.error, zlib.error) as err:
        raise ValueError(f"{name or 'the image'}: a {fmt} file that does not decode "
                         f"({err})") from err
    if flags == IMREAD_COLOR:
        img = orient(_color(img), _exif_orientation(exif))
    return img


def read_image(path: str, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path, flags)`` returns it, with
    its channels in RGB(A) order."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        raise FileNotFoundError(path) from None
    return decode_image(data, flags, path)
