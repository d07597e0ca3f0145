"""Mesh container + OBJ/PLY/GLB I/O (numpy, dependency-free).

Port of ``dreamgaussian_tpu/meshing/mesh.py``: holds vertices/faces,
optional normals, UVs and an albedo texture; loads OBJ (with mtl+map_Kd),
PLY and GLB; writes OBJ (+mtl+png), PLY, and GLB (hand-rolled glTF 2.0
binary with embedded PNG). Textures are written by the port's own
``utils/png.py`` (8-bit RGB) and read, in any format the JAX package reads
them in, by ``utils/imread.py`` as ``cv2.imread``/``cv2.imdecode`` read
them under ``IMREAD_COLOR`` (grey repeated, alpha dropped, 16-bit samples
shifted right by 8, the EXIF or TIFF orientation applied; a TIFF through
libtiff's RGBA interface, as cv2 reads it); a GLB image that no decoder
recognises or that does not decode (a float TIFF or a signed JPEG 2000
among them) leaves the albedo unset, as cv2's None does in the JAX
package, an OBJ's such texture raises, a GLB's one-channel PFM (which
cv2.imdecode returns as one channel) is repeated to three, as OpenCV 5's
``cvtColor(BGR2RGB)`` does in the JAX loader, and a texture in a format
cv2 reads and the port does not (AVIF) raises NotImplementedError.

Conventions match DreamGaussian's so assets cross-load: ``auto_size``
normalizes the mesh to max extent 1.2 about its centroid; ``auto_normal``
uses area-weighted (unnormalized cross product) vertex normals with +z
fallback; ``auto_uv`` produces the xatlas-style (vmapping, ft, vt) triple
with npz caching and optional v-to-vt alignment.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np

from ..utils import ply as plyio
from ..utils import png as pngio
from ..utils.imread import IMREAD_COLOR, decode_image, read_image
from .uv import unwrap


def _safe_normalize(x: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    return x / np.sqrt(
        np.maximum(np.sum(x * x, axis=-1, keepdims=True), eps)
    )


@dataclasses.dataclass
class Mesh:
    v: np.ndarray | None = None      # [V, 3] float32
    f: np.ndarray | None = None      # [F, 3] int32
    vn: np.ndarray | None = None     # [Vn, 3]
    fn: np.ndarray | None = None     # [F, 3]
    vt: np.ndarray | None = None     # [Vt, 2]
    ft: np.ndarray | None = None     # [F, 3]
    albedo: np.ndarray | None = None  # [H, W, 3] float in [0, 1]
    ori_center: np.ndarray | None = None
    ori_scale: float = 1.0

    # ------------------------------------------------------------- loading

    @classmethod
    def load(cls, path: str, resize: bool = True,
             front_dir: str = "+z") -> "Mesh":
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            mesh = cls._load_obj(path)
        elif ext == ".ply":
            mesh = cls._load_ply(path)
        elif ext == ".glb":
            mesh = cls._load_glb(path)
        else:
            raise ValueError(f"unsupported mesh format: {ext}")
        if resize:
            mesh.auto_size()
        if mesh.vn is None:
            mesh.auto_normal()
        if front_dir != "+z":
            mesh._rotate_front(front_dir)
        return mesh

    def _rotate_front(self, front_dir: str) -> None:
        """Rotate so ``front_dir`` faces +z (the orbit cameras' front).

        Axis switch plus an optional multiple of 90 degrees, spelled as
        DreamGaussian spells it: e.g. "+x", "-y",
        "+z1" (front already +z, roll 90 degrees around z).
        """
        eye = np.eye(3, dtype=np.float32)
        if "-z" in front_dir:
            T = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)
        elif "+x" in front_dir:
            T = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float32)
        elif "-x" in front_dir:
            T = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)
        elif "+y" in front_dir:
            T = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)
        elif "-y" in front_dir:
            T = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
        else:
            T = eye
        if "1" in front_dir:
            T = T @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        elif "2" in front_dir:
            T = T @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32)
        elif "3" in front_dir:
            T = T @ np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32)
        self.v = np.asarray(self.v, np.float32) @ T
        if self.vn is not None:
            self.vn = np.asarray(self.vn, np.float32) @ T

    @classmethod
    def _load_obj(cls, path: str) -> "Mesh":
        text = open(path, "r", errors="ignore").read()
        lines = text.splitlines()
        tags = np.array([ln[:3] for ln in lines])

        def block(prefix, width):
            sel = [ln for ln, t in zip(lines, tags) if t.startswith(prefix)]
            if not sel:
                return None
            return np.array(
                [ln.split()[1 : 1 + width] for ln in sel], dtype=np.float32
            )

        v_arr = block("v ", 3)
        vt_arr = block("vt ", 2)
        vn_arr = block("vn ", 3)
        v = v_arr.tolist() if v_arr is not None else []
        vt = vt_arr.tolist() if vt_arr is not None else []
        vn = vn_arr.tolist() if vn_arr is not None else []
        fv, fvt, fvn = [], [], []
        albedo = None
        mtl_path = None
        face_lines = [ln for ln in lines if ln.startswith("f ")]
        for ln in lines:
            if ln.startswith("mtllib"):
                mtl_path = os.path.join(os.path.dirname(path), ln.split()[1])
        if face_lines:
            # Fast path: uniform triangle faces.
            sample = face_lines[0].split()
            uniform_tri = (
                all(len(ln.split()) == 4 for ln in face_lines[:64])
                and "//" not in sample[1]
            )
            if uniform_tri:
                slots = len(sample[1].split("/"))
                flat = " ".join(
                    ln[2:].replace("/", " ") for ln in face_lines
                )
                nums = np.array(flat.split(), dtype=np.int64)
                nums = nums.reshape(len(face_lines), 3, slots) - 1
                fv = nums[:, :, 0].tolist()
                if slots >= 2:
                    fvt = nums[:, :, 1].tolist()
                if slots >= 3:
                    fvn = nums[:, :, 2].tolist()
            else:
                for ln in face_lines:
                    idx = [p.split("/") for p in ln.split()[1:]]
                    for k in range(1, len(idx) - 1):
                        tri = [idx[0], idx[k], idx[k + 1]]
                        fv.append([int(t[0]) - 1 for t in tri])
                        if len(tri[0]) > 1 and tri[0][1]:
                            fvt.append([int(t[1]) - 1 for t in tri])
                        if len(tri[0]) > 2 and tri[0][2]:
                            fvn.append([int(t[2]) - 1 for t in tri])
        if mtl_path and os.path.exists(mtl_path):
            for line in open(mtl_path, "r", errors="ignore"):
                parts = line.strip().split()
                if parts and parts[0] == "map_Kd":
                    tex = os.path.join(os.path.dirname(mtl_path), parts[-1])
                    if os.path.exists(tex):
                        img = read_image(tex, IMREAD_COLOR)
                        albedo = img.astype(np.float32) / 255.0
        return cls(
            v=np.asarray(v, np.float32),
            f=np.asarray(fv, np.int32),
            vt=np.asarray(vt, np.float32) if vt else None,
            ft=np.asarray(fvt, np.int32) if fvt else None,
            vn=np.asarray(vn, np.float32) if vn else None,
            fn=np.asarray(fvn, np.int32) if fvn else None,
            albedo=albedo,
        )

    @classmethod
    def _load_ply(cls, path: str) -> "Mesh":
        elems = plyio.read_ply(path)
        vert = elems["vertex"]
        v = np.stack([vert["x"], vert["y"], vert["z"]], axis=1).astype(
            np.float32
        )
        f = elems.get("face_indices")
        if f is not None:
            f = np.asarray(f, np.int32)
        return cls(v=v, f=f)

    @classmethod
    def _load_glb(cls, path: str) -> "Mesh":
        """Minimal glTF 2.0 binary reader: first mesh primitive with
        POSITION (+ optional NORMAL / TEXCOORD_0 / indices / baseColor
        image). Covers our own writer's layout and standard exporters."""
        raw = open(path, "rb").read()
        magic, version, _ = struct.unpack("<III", raw[:12])
        if magic != 0x46546C67:
            raise ValueError(f"not a glb file: {path}")
        off = 12
        gltf = None
        blob = b""
        while off < len(raw):
            clen, ctype = struct.unpack("<II", raw[off : off + 8])
            data = raw[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:
                gltf = json.loads(data)
            elif ctype == 0x004E4942:
                blob = data
            off += 8 + clen

        def read_accessor(idx):
            acc = gltf["accessors"][idx]
            view = gltf["bufferViews"][acc["bufferView"]]
            start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            comp = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                    5123: np.uint16, 5125: np.uint32, 5126: np.float32}[
                acc["componentType"]
            ]
            ncomp = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}[
                acc["type"]
            ]
            count = acc["count"]
            arr = np.frombuffer(
                blob, dtype=comp, count=count * ncomp, offset=start
            )
            return arr.reshape(count, ncomp) if ncomp > 1 else arr

        prim = gltf["meshes"][0]["primitives"][0]
        attrs = prim["attributes"]
        v = read_accessor(attrs["POSITION"]).astype(np.float32)
        f = read_accessor(prim["indices"]).astype(np.int32).reshape(-1, 3) \
            if "indices" in prim else np.arange(
                len(v), dtype=np.int32).reshape(-1, 3)
        vn = (read_accessor(attrs["NORMAL"]).astype(np.float32)
              if "NORMAL" in attrs else None)
        vt = (read_accessor(attrs["TEXCOORD_0"]).astype(np.float32)
              if "TEXCOORD_0" in attrs else None)
        albedo = None
        if "images" in gltf and gltf["images"]:
            img_meta = gltf["images"][0]
            view = gltf["bufferViews"][img_meta["bufferView"]]
            start = view.get("byteOffset", 0)
            png = blob[start : start + view["byteLength"]]
            try:
                img = decode_image(bytes(png), IMREAD_COLOR)
            except FileNotFoundError:
                img = None              # no format cv2 reads: imdecode returns None
            except ValueError as err:   # a format read here that does not decode
                print(f"[WARN] {path}: the base colour image does not decode ({err}); "
                      f"loading the mesh without a texture, as cv2.imdecode returns None "
                      f"for a malformed file")
                img = None
            if img is not None and img.ndim == 2:
                # cv2.imdecode gives a one-channel PFM one channel under
                # IMREAD_COLOR; OpenCV 5's cvtColor(BGR2RGB) repeats it.
                img = np.repeat(img[..., None], 3, axis=-1)
            if img is not None:
                albedo = img.astype(np.float32) / 255.0
        return cls(
            v=v, f=f, vn=vn, fn=f if vn is not None else None,
            vt=vt, ft=f if vt is not None else None, albedo=albedo,
        )

    # -------------------------------------------------------------- ops

    def aabb(self):
        return self.v.min(axis=0), self.v.max(axis=0)

    def auto_size(self) -> None:
        vmin, vmax = self.aabb()
        self.ori_center = (vmax + vmin) / 2
        self.ori_scale = 1.2 / float(np.max(vmax - vmin))
        self.v = (self.v - self.ori_center) * self.ori_scale

    def auto_normal(self) -> None:
        i0, i1, i2 = self.f[:, 0], self.f[:, 1], self.f[:, 2]
        fn = np.cross(
            self.v[i1] - self.v[i0], self.v[i2] - self.v[i0]
        )
        vn = np.zeros_like(self.v)
        np.add.at(vn, i0, fn)
        np.add.at(vn, i1, fn)
        np.add.at(vn, i2, fn)
        degenerate = np.sum(vn * vn, axis=-1) <= 1e-20
        vn[degenerate] = [0.0, 0.0, 1.0]
        self.vn = _safe_normalize(vn).astype(np.float32)
        self.fn = self.f

    def auto_uv(self, cache_path: str | None = None, vmap: bool = True) -> None:
        if cache_path is not None:
            cache_path = os.path.splitext(cache_path)[0] + "_uv.npz"
        if cache_path is not None and os.path.exists(cache_path):
            data = np.load(cache_path)
            vt, ft, vmapping = data["vt"], data["ft"], data["vmapping"]
        else:
            vmapping, ft, vt = unwrap(self.v, self.f)
            if cache_path is not None:
                np.savez(cache_path, vt=vt, ft=ft, vmapping=vmapping)
        self.vt = vt.astype(np.float32)
        self.ft = ft.astype(np.int32)
        if vmap:
            self.align_v_to_vt(vmapping.astype(np.int64))

    def align_v_to_vt(self, vmapping: np.ndarray | None = None) -> None:
        """Duplicate vertices so v[i] corresponds to vt[i]."""
        if vmapping is None:
            ft = self.ft.reshape(-1).astype(np.int64)
            f = self.f.reshape(-1).astype(np.int64)
            vmapping = np.zeros(self.vt.shape[0], dtype=np.int64)
            vmapping[ft] = f
        self.v = self.v[vmapping]
        self.f = self.ft
        if self.vn is not None:
            self.vn = self.vn[vmapping]
            self.fn = self.ft

    # ------------------------------------------------------------- writing

    def write(self, path: str) -> None:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            self._write_obj(path)
        elif ext == ".ply":
            self._write_ply(path)
        elif ext == ".glb":
            self._write_glb(path)
        else:
            raise ValueError(f"unsupported mesh format: {ext}")

    def _write_obj(self, path: str) -> None:
        base = os.path.splitext(path)[0]
        mtl_name = os.path.basename(base) + ".mtl"
        tex_name = os.path.basename(base) + "_albedo.png"
        # Vectorized text formatting: 100k-face meshes are routine and
        # per-line python f-strings take minutes.
        chunks = [f"mtllib {mtl_name}\n"]
        v = np.asarray(self.v, np.float32)
        chunks.append(
            "".join(
                np.char.add(
                    np.char.add("v ", [" ".join(r) for r in
                                np.char.mod("%.6f", v)]), "\n"
                )
            )
        )
        if self.vt is not None:
            vt = np.stack([self.vt[:, 0], 1.0 - self.vt[:, 1]], axis=1)
            chunks.append(
                "".join(
                    np.char.add(
                        np.char.add("vt ", [" ".join(r) for r in
                                    np.char.mod("%.6f", vt)]), "\n"
                    )
                )
            )
        if self.vn is not None:
            vn = np.asarray(self.vn, np.float32)
            chunks.append(
                "".join(
                    np.char.add(
                        np.char.add("vn ", [" ".join(r) for r in
                                    np.char.mod("%.6f", vn)]), "\n"
                    )
                )
            )
        chunks.append("usemtl defaultMat\n")
        f1 = np.asarray(self.f, np.int64) + 1
        if self.vt is not None and self.vn is not None:
            t1 = np.asarray(self.ft, np.int64) + 1
            n1 = np.asarray(self.fn, np.int64) + 1
            cols = [
                np.char.add(np.char.add(np.char.mod("%d/", f1[:, k]),
                            np.char.mod("%d/", t1[:, k])),
                            np.char.mod("%d", n1[:, k]))
                for k in range(3)
            ]
            rows = np.char.add(
                np.char.add(np.char.add("f ", cols[0]),
                            np.char.add(" ", cols[1])),
                np.char.add(" ", cols[2]),
            )
        elif self.vt is not None:
            t1 = np.asarray(self.ft, np.int64) + 1
            cols = [
                np.char.add(np.char.mod("%d/", f1[:, k]),
                            np.char.mod("%d", t1[:, k]))
                for k in range(3)
            ]
            rows = np.char.add(
                np.char.add(np.char.add("f ", cols[0]),
                            np.char.add(" ", cols[1])),
                np.char.add(" ", cols[2]),
            )
        else:
            rows = np.char.add(
                np.char.add(np.char.add("f ", np.char.mod("%d", f1[:, 0])),
                            np.char.add(" ", np.char.mod("%d", f1[:, 1]))),
                np.char.add(" ", np.char.mod("%d", f1[:, 2])),
            )
        chunks.append("\n".join(rows) + "\n")
        with open(path, "w") as fh:
            fh.write("".join(chunks))
        with open(os.path.join(os.path.dirname(path), mtl_name), "w") as fh:
            fh.write("newmtl defaultMat\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n")
            fh.write("Tr 1\nillum 1\nNs 0\n")
            if self.albedo is not None:
                fh.write(f"map_Kd {tex_name}\n")
        if self.albedo is not None:
            img = (np.clip(self.albedo, 0, 1) * 255).astype(np.uint8)
            pngio.write_png(
                os.path.join(os.path.dirname(path), tex_name), img
            )

    def _write_ply(self, path: str) -> None:
        n = len(self.v)
        vert = np.zeros(
            n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")]
        )
        vert["x"], vert["y"], vert["z"] = self.v.T
        plyio.write_ply_with_faces(path, vert, self.f.astype(np.int32))

    def _write_glb(self, path: str) -> None:
        """Minimal glTF 2.0 binary with POSITION/NORMAL/TEXCOORD_0 + PNG."""
        v = np.ascontiguousarray(self.v, np.float32)
        f = np.ascontiguousarray(self.f, np.uint32).reshape(-1)
        buffers = [f.tobytes(), v.tobytes()]
        accessors = [
            {
                "bufferView": 0, "componentType": 5125,
                "count": int(f.size), "type": "SCALAR",
                "max": [int(f.max()) if f.size else 0], "min": [0],
            },
            {
                "bufferView": 1, "componentType": 5126,
                "count": len(v), "type": "VEC3",
                "max": v.max(axis=0).tolist(), "min": v.min(axis=0).tolist(),
            },
        ]
        attributes = {"POSITION": 1}
        if self.vn is not None:
            vn = np.ascontiguousarray(self.vn, np.float32)
            buffers.append(vn.tobytes())
            accessors.append(
                {"bufferView": len(buffers) - 1, "componentType": 5126,
                 "count": len(vn), "type": "VEC3"}
            )
            attributes["NORMAL"] = len(accessors) - 1
        images = []
        textures = []
        samplers = []
        material: dict = {
            "pbrMetallicRoughness": {
                "metallicFactor": 0.0, "roughnessFactor": 1.0,
            }
        }
        if self.vt is not None:
            vt = np.ascontiguousarray(self.vt, np.float32)
            buffers.append(vt.tobytes())
            accessors.append(
                {"bufferView": len(buffers) - 1, "componentType": 5126,
                 "count": len(vt), "type": "VEC2"}
            )
            attributes["TEXCOORD_0"] = len(accessors) - 1
        if self.albedo is not None and self.vt is not None:
            img = (np.clip(self.albedo, 0, 1) * 255).astype(np.uint8)
            buffers.append(pngio.encode_png(img))
            images.append(
                {"bufferView": len(buffers) - 1, "mimeType": "image/png"}
            )
            samplers.append(
                {"magFilter": 9729, "minFilter": 9987,
                 "wrapS": 10497, "wrapT": 10497}
            )
            textures.append({"sampler": 0, "source": 0})
            material["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": 0
            }

        # bufferViews with 4-byte alignment in one blob.
        blob = b""
        views = []
        for data in buffers:
            off = len(blob)
            views.append(
                {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
            )
            blob += data + b"\x00" * ((4 - len(data) % 4) % 4)

        gltf = {
            "asset": {"version": "2.0", "generator": "dreamgaussian_tpu_torch"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [
                {
                    "primitives": [
                        {
                            "attributes": attributes,
                            "indices": 0,
                            "material": 0,
                        }
                    ]
                }
            ],
            "materials": [material],
            "accessors": accessors,
            "bufferViews": views,
            "buffers": [{"byteLength": len(blob)}],
        }
        if images:
            gltf["images"] = images
            gltf["textures"] = textures
            gltf["samplers"] = samplers

        js = json.dumps(gltf).encode()
        js += b" " * ((4 - len(js) % 4) % 4)
        total = 12 + 8 + len(js) + 8 + len(blob)
        with open(path, "wb") as fh:
            fh.write(struct.pack("<III", 0x46546C67, 2, total))
            fh.write(struct.pack("<II", len(js), 0x4E4F534A))
            fh.write(js)
            fh.write(struct.pack("<II", len(blob), 0x004E4942))
            fh.write(blob)
