"""The mesh-export modules of the PyTorch port against the JAX package on the
same numpy inputs: occupancy field, isosurface, the native mesh tools, UV
unwrap, Mesh I/O with the port's own PNG codec, the texture bake, and
``export_textured_mesh`` as a whole. The JAX side runs its Pallas z-test in
interpret mode on the CPU."""

import functools
import math
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu import native as jnative
from dreamgaussian_tpu.meshing import export as jex
from dreamgaussian_tpu.meshing import mesh as jmesh
from dreamgaussian_tpu.meshing import occupancy as jocc
from dreamgaussian_tpu.meshing import uv as juv
from dreamgaussian_tpu.meshing.marching_cubes import marching_cubes as j_marching_cubes
from dreamgaussian_tpu_torch import native as tnative
from dreamgaussian_tpu_torch import weights as tweights
from dreamgaussian_tpu_torch.meshing import export as tex
from dreamgaussian_tpu_torch.meshing import mesh as tmesh
from dreamgaussian_tpu_torch.meshing import occupancy as tocc
from dreamgaussian_tpu_torch.meshing import uv as tuv
from dreamgaussian_tpu_torch.meshing.marching_cubes import marching_cubes as t_marching_cubes
from dreamgaussian_tpu_torch.utils import png as tpng

FOVY = math.radians(49.1)


@functools.lru_cache(maxsize=None)
def _cloud(n=600, cap=1024, seed=0):
    """A seeded solid ellipsoid of overlapping gaussians in padded arrays,
    with dead slots and a few near-transparent gaussians."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n, 3))
    r = 0.5 * np.cbrt(u[:, 0])
    phi, ct = 2 * np.pi * u[:, 1], 2 * u[:, 2] - 1
    st = np.sqrt(1 - ct ** 2)
    xyz = np.stack([r * st * np.cos(phi), 0.7 * r * st * np.sin(phi), r * ct], 1)

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        return np.concatenate([x, np.full((cap - n,) + x.shape[1:], fill, np.float32)])

    opacity = rng.uniform(0.5, 3.0, size=(n, 1))
    opacity[::50] = -8.0                       # sigmoid < 0.005: filtered out
    params = {
        "xyz": pad(xyz), "f_dc": pad(rng.normal(size=(n, 1, 3))),
        "f_rest": np.zeros((cap, 0, 3), np.float32), "opacity": pad(opacity),
        "scaling": pad(np.log(rng.uniform(0.06, 0.12, size=(n, 3))), -10.0),
        "rotation": pad(rng.normal(size=(n, 4))),
    }
    params["rotation"][n:, 0] = 1.0
    return params, np.arange(cap) < n


def _jax_cloud():
    params, alive = _cloud()
    return {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive)


def _torch_cloud():
    return tweights.cloud_from_numpy(*_cloud(), device="cpu")


def _render(cam):
    """A stand-in for the gaussian render: a smooth image that depends on the
    camera, the same numpy array for both packages."""
    yy, xx = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
    shade = 0.5 + 0.4 * float(cam.arrays()["view"][0, 0])
    return np.stack([xx / cam.width, yy / cam.height, np.full_like(xx, shade)], -1)


@functools.lru_cache(maxsize=None)
def _fields(resolution=32):
    j = jocc.extract_occupancy_field(*_jax_cloud(), resolution=resolution)
    t = tocc.extract_occupancy_field(*_torch_cloud(), resolution=resolution, device="cpu")
    return j, t


def test_occupancy_field_and_transform():
    """Field to 1e-4 of its maximum (two float32 matrix products summed in
    another order); the transform to float32 rounding."""
    (j_occ, j_tf), (t_occ, t_tf) = _fields()
    assert j_occ.shape == t_occ.shape == (32, 32, 32) and j_occ.max() > 2.0
    np.testing.assert_allclose(t_occ, j_occ, rtol=0, atol=1e-4 * j_occ.max())
    np.testing.assert_allclose(t_tf.center, j_tf.center, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_tf.scale, j_tf.scale, rtol=1e-6)
    v = np.random.default_rng(0).uniform(0, 31, size=(10, 3))
    np.testing.assert_allclose(t_tf.grid_to_world(v, 32), j_tf.grid_to_world(v, 32), atol=1e-6)


def test_occupancy_streams_the_grid_in_blocks():
    """The field does not depend on how the grid is cut into blocks."""
    params, alive = _torch_cloud()
    keep = alive & (torch.sigmoid(params["opacity"][:, 0]) > 0.005)
    mu = params["xyz"] * 1.8
    m = torch.diag_embed(torch.exp(params["scaling"]) * 1.8)
    inv6, ok = tocc._inv_cov_features(m @ m.transpose(1, 2))
    opa = torch.where(keep & ok, torch.sigmoid(params["opacity"][:, 0]), torch.zeros(()))
    whole = tocc._field_on_grid(mu, inv6, opa, 12)
    blocks = tocc._field_on_grid(mu, inv6, opa, 12, plane_bytes=4 * mu.shape[0] * 100)
    np.testing.assert_allclose(blocks.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)


def test_degenerate_covariance_gives_zero_density():
    cov = torch.zeros((2, 3, 3))
    cov[1] = torch.eye(3) * 0.01
    j_inv, j_ok = jocc._inv_cov_features(jnp.asarray(cov.numpy()))
    t_inv, t_ok = tocc._inv_cov_features(cov)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(j_inv), rtol=1e-6)
    assert not t_inv[0].any()


def test_marching_cubes_equal_on_the_same_field():
    (j_occ, _), _ = _fields()
    jv, jf = j_marching_cubes(j_occ, 1.0)
    tv, tf = t_marching_cubes(j_occ, 1.0)
    assert len(jf) > 1000
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    ev, ef = t_marching_cubes(j_occ, 1e9)
    assert ev.shape == (0, 3) and ef.shape == (0, 3)


@functools.lru_cache(maxsize=None)
def _surface():
    """A cleaned isosurface in world units with seeded jitter on the
    vertices, so that no two collapse costs tie."""
    (j_occ, j_tf), _ = _fields()
    v, f = j_marching_cubes(j_occ, 1.0)
    v, f = jnative.clean_mesh(j_tf.grid_to_world(v, 32), f)
    v = jnative.laplacian_smooth(v.copy(), f, 2, 0.5)
    return v + np.random.default_rng(1).normal(size=v.shape) * 1e-4, f


def test_native_tools_equal_on_the_same_input():
    """The port builds its own copy of the same source, without the JAX
    loader's -march=native, which lets the compiler fuse multiply-adds: the
    topology is equal and vertices agree to 1e-9."""
    (j_occ, j_tf), _ = _fields()
    v, f = j_marching_cubes(j_occ, 1.0)
    world = j_tf.grid_to_world(v, 32)
    jc, tc = jnative.clean_mesh(world, f), tnative.clean_mesh(world, f)
    np.testing.assert_array_equal(tc[1], jc[1])
    np.testing.assert_allclose(tc[0], jc[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tnative.laplacian_smooth(jc[0].copy(), jc[1], 2, 0.5),
                               jnative.laplacian_smooth(jc[0].copy(), jc[1], 2, 0.5),
                               rtol=0, atol=1e-12)
    sv, sf = _surface()
    for name, args in (("isotropic_remesh", (0.06, 5)), ("decimate_mesh", (4000,))):
        jv, jf = getattr(jnative, name)(sv, sf, *args)
        tv, tf = getattr(tnative, name)(sv, sf, *args)
        assert len(jf) > 500 and len(jf) != len(sf), name
        np.testing.assert_array_equal(tf, jf, err_msg=name)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9, err_msg=name)


def test_native_tools_reject_faces_outside_the_vertices():
    v = np.zeros((3, 3))
    for name, args in (("clean_mesh", ()), ("decimate_mesh", (1,)), ("laplacian_smooth", ()),
                       ("isotropic_remesh", (0.1,))):
        with pytest.raises(ValueError):
            getattr(tnative, name)(v, np.array([[0, 1, 3]]), *args)
        with pytest.raises(ValueError):
            getattr(tnative, name)(v[:, :2], np.array([[0, 1, 2]]), *args)


def test_native_library_is_built_outside_the_package():
    so = tnative.build()
    repo = tnative.SRC.parents[2]
    assert so.exists() and so.parent == repo / "build" / "native"
    assert not list((repo / "dreamgaussian_tpu_torch").rglob("*.so"))


def test_unwrap_equal_on_the_same_mesh():
    sv, sf = _surface()
    dv, df = jnative.decimate_mesh(sv, sf, 2000)
    for a, b in zip(tuv.unwrap(dv, df), juv.unwrap(dv, df)):
        np.testing.assert_array_equal(a, b)


def _textured_mesh(cls):
    sv, sf = _surface()
    dv, df = jnative.decimate_mesh(sv, sf, 1500)
    mesh = cls(v=dv.astype(np.float32), f=df.astype(np.int32))
    mesh.auto_normal()
    mesh.auto_uv()
    rng = np.random.default_rng(2)
    mesh.albedo = rng.uniform(size=(48, 40, 3)).astype(np.float32)
    return mesh


def test_mesh_ops_match_jax():
    jm, tm = _textured_mesh(jmesh.Mesh), _textured_mesh(tmesh.Mesh)
    for k in ("v", "f", "vn", "fn", "vt", "ft"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), err_msg=k)
    jm.auto_size()
    tm.auto_size()
    np.testing.assert_array_equal(tm.v, jm.v)
    assert tm.ori_scale == jm.ori_scale


@pytest.mark.parametrize("ext", ["obj", "ply", "glb"])
def test_mesh_write_load_round_trip(tmp_path, ext):
    """Written by the port and read back by the port and by the JAX package
    (whose texture decoder is cv2): geometry to the format's precision (OBJ
    prints six decimals), texture to 1/255."""
    mesh = _textured_mesh(tmesh.Mesh)
    path = str(tmp_path / f"m.{ext}")
    mesh.write(path)
    atol = 1e-6 if ext == "obj" else 0.0
    for loader in (tmesh.Mesh, jmesh.Mesh):
        back = loader.load(path, resize=False)
        np.testing.assert_allclose(back.v, mesh.v, rtol=0, atol=atol)
        np.testing.assert_array_equal(back.f, mesh.f)
        if ext == "ply":
            assert back.vt is None and back.albedo is None
            continue
        # OBJ stores v flipped (1 - v), and the loaders keep it so.
        vt = np.stack([mesh.vt[:, 0], 1 - mesh.vt[:, 1]], 1) if ext == "obj" else mesh.vt
        np.testing.assert_allclose(back.vt, vt, rtol=0, atol=atol)
        np.testing.assert_array_equal(back.ft, mesh.ft)
        np.testing.assert_allclose(back.vn, mesh.vn, rtol=0, atol=atol)
        np.testing.assert_allclose(back.albedo, mesh.albedo, rtol=0, atol=1 / 255)


def test_mesh_load_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError):
        tmesh.Mesh.load(str(tmp_path / "m.stl"))
    with pytest.raises(ValueError):
        _textured_mesh(tmesh.Mesh).write(str(tmp_path / "m.stl"))


def test_auto_uv_cache(tmp_path):
    mesh = _textured_mesh(tmesh.Mesh)
    again = tmesh.Mesh(v=np.zeros_like(mesh.v), f=mesh.f)
    cache = str(tmp_path / "m.obj")
    src = tmesh.Mesh(v=mesh.v.copy(), f=mesh.f.copy())
    src.auto_uv(cache_path=cache, vmap=False)
    assert os.path.exists(str(tmp_path / "m_uv.npz"))
    again.auto_uv(cache_path=cache, vmap=False)      # read from the cache
    np.testing.assert_array_equal(again.vt, src.vt)
    np.testing.assert_array_equal(again.ft, src.ft)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("writer", ["port", "cv2"])
def test_png_against_cv2(tmp_path, writer, channels):
    """The port's PNG codec against cv2's on the same file, both ways. cv2
    picks its row filters adaptively, so its files exercise the reader's
    Sub/Up/Average/Paeth paths; a smooth image makes it choose them."""
    yy, xx = np.mgrid[0:37, 0:53]
    rng = np.random.default_rng(3)
    img = np.stack([(xx * 4 + yy) % 256, (yy * 6) % 256, (xx * yy) % 256,
                    255 - (xx + yy) % 256][:channels], -1).astype(np.uint8)
    img[5:12, 7:30] = rng.integers(0, 256, size=(7, 23, channels))
    path = str(tmp_path / "t.png")
    bgr = img[..., [2, 1, 0] + ([3] if channels == 4 else [])]
    if writer == "port":
        tpng.write_png(path, img)
    else:
        assert cv2.imwrite(path, bgr)
    np.testing.assert_array_equal(tpng.read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), bgr)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_undoes_every_filter(kind):
    """A file whose rows all use one filter type, encoded here by the
    filter's definition."""
    import struct
    import zlib

    rng = np.random.default_rng(kind)
    img = rng.integers(0, 256, size=(9, 11, 3)).astype(np.uint8)
    rows = img.reshape(9, 33).astype(np.int64)
    left = np.concatenate([np.zeros((9, 3), np.int64), rows[:, :-3]], 1)
    up = np.concatenate([np.zeros((1, 33), np.int64), rows[:-1]], 0)
    upleft = np.concatenate([np.zeros((9, 3), np.int64), up[:, :-3]], 1)
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = [0 * rows, left, up, (left + up) // 2, paeth][kind]
    raw = np.concatenate([np.full((9, 1), kind), (rows - pred) % 256], 1).astype(np.uint8)
    data = (b"\x89PNG\r\n\x1a\n"
            + tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 0))
            + tpng._chunk(b"IDAT", zlib.compress(raw.tobytes())) + tpng._chunk(b"IEND", b""))
    np.testing.assert_array_equal(tpng.decode_png(data), img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1], img)


def test_png_rejects_what_it_does_not_read():
    """Every PNG of the specification is read (16-bit ones too, held in
    test_torch_image_formats.py); a header outside it is refused, as libpng
    refuses it, and the writer takes 8-bit RGB(A) only."""
    with pytest.raises(ValueError):
        tpng.decode_png(b"not a png")
    ok, sixteen = cv2.imencode(".png", np.zeros((4, 4, 3), np.uint16))
    assert ok
    data = bytearray(sixteen.tobytes())
    data[25] = 3                                   # colour type 3 (palette) at 16 bits
    with pytest.raises(ValueError, match="out of the specification"):
        tpng.decode_png(bytes(data))
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError):
        tpng.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        tpng.encode_png(np.zeros((4, 4, 3), np.uint16))


def test_extract_mesh_raises_on_empty_isosurface():
    with pytest.raises(ValueError, match="empty isosurface"):
        tex.extract_mesh(*_torch_cloud(), density_thresh=1e6, resolution=16, device="cpu")


def test_export_needs_a_card_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.extract_mesh(*_torch_cloud(), resolution=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.bake_texture(_textured_mesh(tmesh.Mesh), _render, fovy=FOVY)


EXPORT_KW = dict(fovy=FOVY, texture_size=128, bake_resolution=64, mc_resolution=32,
                 remesh_size=0.0, decimate_target=100_000)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One seeded cloud through both packages' ``export_textured_mesh``:
    mc_resolution 32, texture 128, bake 64, the same render function.
    Remesh and decimation are left out here: their discrete choices amplify
    a 1e-7 shift of a vertex, and they are held on the same input above."""
    out = tmp_path_factory.mktemp("export")
    stats = {}
    jm = jex.export_textured_mesh(*_jax_cloud(), _render, str(out / "j.obj"), **EXPORT_KW)
    tm = tex.export_textured_mesh(*_torch_cloud(), _render, str(out / "t.obj"), device="cpu",
                                  stats=stats, **EXPORT_KW)
    return jm, tm, stats, out


def test_bake_on_the_same_mesh_matches_jax(exports):
    """The port's bake on the mesh that the JAX package exported, with the
    same per-view images: every texel of the 128^2 albedo within 1e-4 of
    the JAX package's (26 views of float32 scatter sums, then the same host
    inpaint)."""
    jm = exports[0]
    mesh = tmesh.Mesh(v=jm.v, f=jm.f, vn=jm.vn, fn=jm.fn, vt=jm.vt, ft=jm.ft)
    stats = {}
    albedo = tex.bake_texture(mesh, _render, fovy=FOVY, texture_size=128, render_resolution=64,
                              min_resolution=32, device="cpu", stats=stats)
    assert stats["covered_share"] > 0.2
    np.testing.assert_allclose(albedo, jm.albedo, rtol=0, atol=1e-4)


def test_export_textured_mesh_matches_jax(exports):
    """The slice as a whole. The mesh is the same: faces and UV faces equal,
    vertices to 1e-5, UVs to 5e-4 (the LSCM solve amplifies the vertices'
    float32 differences). The albedo agrees within 5e-3 on at least 95% of
    the texels; the rest sit where a discrete choice flips (a texel at the
    first-view-wins threshold, the nearest seen texel of the inpaint)."""
    jm, tm, stats, out = exports
    assert len(tm.f) > 5000 and stats["faces"] == len(tm.f)
    np.testing.assert_array_equal(tm.f, jm.f)
    np.testing.assert_array_equal(tm.ft, jm.ft)
    np.testing.assert_allclose(tm.v, jm.v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.vt, jm.vt, rtol=0, atol=5e-4)
    diff = np.abs(tm.albedo - jm.albedo).max(-1)
    assert (diff <= 5e-3).mean() >= 0.95, (diff <= 5e-3).mean()
    for name in ("field_s", "isosurface_s", "clean_remesh_decimate_s", "uv_s", "bake_s",
                 "inpaint_s", "write_s"):
        assert stats[name] >= 0.0
    back = tmesh.Mesh.load(str(out / "t.obj"), resize=False)
    np.testing.assert_array_equal(back.f, tm.f)
    np.testing.assert_allclose(back.albedo, np.clip(tm.albedo, 0, 1), rtol=0, atol=1 / 255)


def test_export_through_the_trainer_bakes_the_cloud_colour(tmp_path):
    """The product flow on the CPU at a small size: a cloud of one colour
    enters a trainer as a PLY, and the export bakes the trainer's own
    ``render_view`` (the gaussian renderer's plain K1) through the mesh
    rasterizer (the plain K3). The texels the views saw carry the cloud's
    colour: the median error is under 0.01 and 85% lie within 0.05 (the
    opaque blob hides the white background except along silhouettes, which
    at 64^2 views are a tenth of the seen texels)."""
    from dreamgaussian_tpu_torch.scene import GaussianAux, save_ply
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    params, alive = _torch_cloud()
    rgb = torch.tensor([0.2, 0.5, 0.8])
    params = dict(params, f_dc=((rgb - 0.5) / 0.28209479177387814).expand(len(alive), 1, 3),
                  opacity=torch.full_like(params["opacity"], 3.0))
    zeros = torch.zeros(len(alive))
    ply = str(tmp_path / "cloud.ply")
    n = save_ply(ply, params, GaussianAux(alive=alive, max_radii2d=zeros, grad_accum=zeros,
                                          denom=zeros))
    trainer = Stage1Trainer(Config({"load": ply, "fovy": 49.1, "radius": 2.0}),
                            capacity=1024, device="cpu")
    assert int(trainer.aux.alive.sum()) == n == int(alive.sum())
    stats = {}
    mesh = tex.export_textured_mesh(
        trainer.params, trainer.aux.alive, lambda cam: trainer.render_view(cam).image,
        str(tmp_path / "m.glb"), fovy=trainer.fovy, radius=trainer.radius, texture_size=64,
        bake_resolution=64, mc_resolution=24, remesh_size=0.08, decimate_target=2000,
        device="cpu", stats=stats)
    assert 0 < len(mesh.f) <= 2000 and stats["covered_share"] > 0.15
    back = tmesh.Mesh.load(str(tmp_path / "m.glb"), resize=False)
    np.testing.assert_array_equal(back.f, mesh.f)
    bake_only = tex.bake_texture(mesh, lambda cam: trainer.render_view(cam).image,
                                 fovy=trainer.fovy, radius=trainer.radius, texture_size=64,
                                 render_resolution=64, min_resolution=16, inpaint=False,
                                 device="cpu")
    err = np.abs(bake_only[bake_only.sum(-1) > 0] - rgb.numpy()).max(-1)
    assert np.median(err) <= 0.01 and (err <= 0.05).mean() >= 0.85


def test_export_with_remesh_and_decimation_gives_the_same_surface(tmp_path):
    """With the remesh and the decimation on, both packages give a mesh of
    the target size on the same surface: every vertex of one lies within
    half the remesh length of a vertex of the other."""
    from scipy.spatial import cKDTree

    jmesh_out = jex.extract_mesh(*_jax_cloud(), resolution=32, remesh_size=0.06,
                                 decimate_target=3000)
    tmesh_out = tex.extract_mesh(*_torch_cloud(), resolution=32, remesh_size=0.06,
                                 decimate_target=3000, device="cpu")
    for m in (jmesh_out, tmesh_out):
        assert 2900 <= len(m.f) <= 3000
    assert cKDTree(jmesh_out.v).query(tmesh_out.v)[0].max() < 0.03
    assert cKDTree(tmesh_out.v).query(jmesh_out.v)[0].max() < 0.03
