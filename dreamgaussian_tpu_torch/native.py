"""ctypes loader for the port's host-side native code.

Five sources under ``csrc/``: ``mesh_tools.cpp`` (the port's own copy of
``dreamgaussian_tpu/native/``'s, wrapped below), ``image_tools.cpp`` (the
JPEG decoder's Huffman, arithmetic and lossless scans and its pixel work,
and GrabCut's min-cut, wrapped by
``utils/jpeg.py`` and ``preprocess/grabcut.py``), ``image_codecs.cpp``
(PNG's row filters, GIF's LZW, WebP's VP8L, VP8 and alpha planes, TIFF's
LZW, PackBits, CCITT, ThunderScan, SGILog and predictors, Radiance HDR's
RGBE pixels, wrapped by ``utils/png.py``, ``gif.py``, ``webp.py``,
``tiff.py`` and ``hdr.py``), ``jpeg2000.cpp`` (the JPEG
2000 codestream decoder, wrapped by ``utils/jpeg2000.py``) and
``h264_intra.cpp`` (the H.264 intra encoder, wrapped by ``utils/mp4.py``);
``image_tools()``, ``image_codecs()``, ``jpeg2000()`` and ``h264_intra()``
declare every function of theirs, once. Each shared library is
compiled at first use into ``build/native/`` at the root of the checkout,
under a name that carries the hash of its source and the flags, so an
edited source is rebuilt. The host compiler is ``g++``; where there is
none, the same file goes through ``nvcc``, which drives its own host
compiler. The flags name no machine-specific instruction set (no
``-march=native``); ``jpeg2000.cpp`` and ``image_codecs.cpp`` add
``-ffp-contract=off``, since their float arithmetic (the wavelet and colour
transforms, SGILog's XYZ and OpenCV's XYZ-to-RGB) must round as OpenJPEG's,
libtiff's and OpenCV's do, with no fused multiply-add. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "mesh_tools.cpp"
IMAGE_TOOLS = SRC.with_name("image_tools.cpp")
IMAGE_CODECS = SRC.with_name("image_codecs.cpp")
JPEG2000 = SRC.with_name("jpeg2000.cpp")
H264_INTRA = SRC.with_name("h264_intra.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
SOURCE_FLAGS = {"jpeg2000.cpp": ("-ffp-contract=off",),
                "image_codecs.cpp": ("-ffp-contract=off",)}
_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


def _compile_command(src: Path, out: Path) -> list[str]:
    extra = SOURCE_FLAGS.get(src.name, ())
    gxx = shutil.which("g++")
    if gxx:
        return [gxx, *CXX_FLAGS, *extra, str(src), "-o", str(out)]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if os.path.exists(nvcc):
        return [nvcc, "-x", "c++", "-O3", "-std=c++17", "-shared", "-Xcompiler",
                ",".join(("-fPIC", *extra)), str(src), "-o", str(out)]
    raise RuntimeError(f"neither g++ nor nvcc found: cannot build {src.name}")


def library_path(src: Path = SRC) -> Path:
    flags = (*CXX_FLAGS, *SOURCE_FLAGS.get(src.name, ()))
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(src: Path = SRC) -> Path:
    """Compile ``src`` if its library is missing; returns the library's path."""
    so = library_path(src)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(_compile_command(src, tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def _load(src: Path, declare) -> ctypes.CDLL:
    """The library of ``src``, built and loaded once per process;
    ``declare(lib)`` sets every function's argtypes and restype."""
    with _LOCK:
        if src not in _LIBS:
            lib = ctypes.CDLL(str(build(src)))
            declare(lib)
            _LIBS[src] = lib
    return _LIBS[src]


def _declare_image_tools(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.dg_jpeg_scan.argtypes = [vp, i64, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                 i32, i32, vp]
    lib.dg_jpeg_arith_scan.argtypes = [vp, i64, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                       i32, i32, i32, vp]
    lib.dg_jpeg_lossless_scan.argtypes = [vp, i64, i32, vp, vp, vp, i32, i32, i32, i32, i32,
                                          i32, i32, vp]
    lib.dg_jpeg_finish.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, i32, vp, vp]
    lib.dg_jpeg_lossless_finish.argtypes = [i32, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.dg_maxflow.argtypes = [i32, i64, vp, vp, vp, vp, vp, vp, vp, vp]
    for fn in (lib.dg_jpeg_scan, lib.dg_jpeg_arith_scan, lib.dg_jpeg_lossless_scan,
               lib.dg_jpeg_finish, lib.dg_jpeg_lossless_finish, lib.dg_maxflow):
        fn.restype = ctypes.c_int


def image_tools() -> ctypes.CDLL:
    """``csrc/image_tools.cpp``'s library with its functions declared."""
    return _load(IMAGE_TOOLS, _declare_image_tools)


def _declare_image_codecs(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.dg_png_unfilter.argtypes = [vp, i32, i64, i32, vp]
    lib.dg_gif_lzw.argtypes = [vp, i64, i32, vp, i64, vp]
    lib.dg_webp_vp8l.argtypes = [vp, i64, i32, i32, vp]
    lib.dg_webp_vp8.argtypes = [vp, i64, i32, i32, vp, i32]
    lib.dg_webp_alpha_unfilter.argtypes = [vp, i32, i32, i32]
    lib.dg_tiff_decompress.argtypes = [vp, i64, i32, vp, i64, i32, i32, i32, vp]
    lib.dg_tiff_unpredict.argtypes = [vp, i64, i64, i32, i32, i32]
    lib.dg_sgilog_decode.argtypes = [vp, i64, i32, i32, i32, i32, vp, vp]
    lib.dg_hdr_decode.argtypes = [vp, i64, i32, i32, vp]
    lib.dg_xyz_to_rgb.argtypes = [vp, i32, i32]
    lib.dg_xyz_to_rgb.restype = None
    for fn in (lib.dg_png_unfilter, lib.dg_gif_lzw, lib.dg_webp_vp8l, lib.dg_webp_vp8,
               lib.dg_webp_alpha_unfilter, lib.dg_tiff_decompress, lib.dg_tiff_unpredict,
               lib.dg_sgilog_decode, lib.dg_hdr_decode):
        fn.restype = ctypes.c_int


def image_codecs() -> ctypes.CDLL:
    """``csrc/image_codecs.cpp``'s library with its functions declared."""
    return _load(IMAGE_CODECS, _declare_image_codecs)


def _declare_jpeg2000(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.dg_j2k_info.argtypes = [vp, i64, vp, i32, vp, i32]
    lib.dg_j2k_decode.argtypes = [vp, i64, vp, vp, i32]
    for fn in (lib.dg_j2k_info, lib.dg_j2k_decode):
        fn.restype = ctypes.c_int


def jpeg2000() -> ctypes.CDLL:
    """``csrc/jpeg2000.cpp``'s library with its functions declared."""
    return _load(JPEG2000, _declare_jpeg2000)


def _declare_h264_intra(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.dg_h264_headers.argtypes = [i32, i32, i32, i32, vp, i32, vp, vp, i32]
    lib.dg_h264_encode.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp, vp, vp, i64, vp, vp,
                                   vp, i32]
    for fn in (lib.dg_h264_headers, lib.dg_h264_encode):
        fn.restype = ctypes.c_int


def h264_intra() -> ctypes.CDLL:
    """``csrc/h264_intra.cpp``'s library with its functions declared."""
    return _load(H264_INTRA, _declare_h264_intra)


def _declare_mesh_tools(lib: ctypes.CDLL) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.clean_mesh.argtypes = [
        dp, ctypes.c_int, ip, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, dp, ip, ip, ip,
    ]
    lib.decimate_mesh.argtypes = [
        dp, ctypes.c_int, ip, ctypes.c_int, ctypes.c_int,
        dp, ip, ip, ip,
    ]
    lib.laplacian_smooth.argtypes = [
        dp, ctypes.c_int, ip, ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
    ]
    lib.isotropic_remesh.argtypes = [
        dp, ctypes.c_int, ip, ctypes.c_int,
        ctypes.c_double, ctypes.c_int,
        dp, ctypes.c_int32, ip, ip, ctypes.c_int32, ip,
    ]
    for fn in (lib.clean_mesh, lib.decimate_mesh, lib.laplacian_smooth,
               lib.isotropic_remesh):
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _load(SRC, _declare_mesh_tools)


def _as_c(verts: np.ndarray, faces: np.ndarray):
    """Contiguous float64 [V, 3] vertices and int32 [F, 3] faces; the native
    code indexes without checks, so the faces are checked here."""
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"expected [V, 3] vertices and [F, 3] faces, got {v.shape} and {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("a face index lies outside the vertex array")
    return v, f


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check(ret: int, name: str) -> None:
    if ret != 0:
        raise RuntimeError(f"{name} failed with code {ret}")


def clean_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    weld_eps: float = 1e-6,
    min_comp_frac: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Weld near-duplicate vertices, drop degenerate faces, unreferenced
    vertices, and connected components smaller than ``min_comp_frac`` of
    the largest."""
    v, f = _as_c(verts, faces)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv = np.zeros(1, np.int32)
    nf = np.zeros(1, np.int32)
    _check(_lib().clean_mesh(
        _dptr(v), len(v), _iptr(f), len(f), weld_eps, min_comp_frac,
        _dptr(out_v), _iptr(nv), _iptr(out_f), _iptr(nf),
    ), "clean_mesh")
    return out_v[: nv[0]].copy(), out_f[: nf[0]].copy()


def decimate_mesh(
    verts: np.ndarray, faces: np.ndarray, target_faces: int
) -> tuple[np.ndarray, np.ndarray]:
    """Quadric edge-collapse to about ``target_faces`` faces."""
    v, f = _as_c(verts, faces)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv = np.zeros(1, np.int32)
    nf = np.zeros(1, np.int32)
    _check(_lib().decimate_mesh(
        _dptr(v), len(v), _iptr(f), len(f), int(target_faces),
        _dptr(out_v), _iptr(nv), _iptr(out_f), _iptr(nf),
    ), "decimate_mesh")
    return out_v[: nv[0]].copy(), out_f[: nf[0]].copy()


def isotropic_remesh(
    verts: np.ndarray, faces: np.ndarray, target_len: float,
    n_iter: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """Botsch-Kobbelt isotropic explicit remeshing toward a uniform
    target edge length."""
    v, f = _as_c(verts, faces)
    # Capacity: expected face count at the target length (equilateral
    # tiling of the surface area) with generous headroom.
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1).sum()
    est_f = int(area / (np.sqrt(3) / 4.0 * target_len ** 2 + 1e-18))
    cap_f = max(len(f), est_f) * 3 + 1024
    cap_v = cap_f // 2 + 1024
    out_v = np.empty((cap_v, 3), np.float64)
    out_f = np.empty((cap_f, 3), np.int32)
    nv = np.zeros(1, np.int32)
    nf = np.zeros(1, np.int32)
    _check(_lib().isotropic_remesh(
        _dptr(v), len(v), _iptr(f), len(f), float(target_len), int(n_iter),
        _dptr(out_v), cap_v, _iptr(nv), _iptr(out_f), cap_f, _iptr(nf),
    ), "isotropic_remesh")
    return out_v[: nv[0]].copy(), out_f[: nf[0]].copy()


def laplacian_smooth(
    verts: np.ndarray, faces: np.ndarray, n_iter: int = 2, lam: float = 0.5
) -> np.ndarray:
    """Uniform Laplacian smoothing; returns the moved vertices."""
    v, f = _as_c(verts, faces)
    _check(_lib().laplacian_smooth(
        _dptr(v), len(v), _iptr(f), len(f), int(n_iter), float(lam),
    ), "laplacian_smooth")
    return v
