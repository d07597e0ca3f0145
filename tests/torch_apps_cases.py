"""Inputs of the port's apps tests, shared by the CPU and the card tests (no
JAX): a seeded gaussian PLY, a textured UV-sphere OBJ, the batch script as a
module, and a local HTTP server for the handlers."""

import importlib.util
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.utils import ply as plyio


def write_cloud_ply(path, n=400, seed=0):
    """A seeded cloud of ``n`` gaussians in a ball of radius 0.5 (degree-0
    SH), as a GS-standard PLY."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * 0.25
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    for name in ("nx", "ny", "nz"):
        cols[name] = np.zeros(n)
    for i in range(3):
        cols[f"f_dc_{i}"] = rng.normal(size=n) * 0.8
    cols["opacity"] = rng.normal(size=n)
    for i in range(3):
        cols[f"scale_{i}"] = rng.uniform(-4.0, -2.5, size=n)
    for i in range(4):
        cols[f"rot_{i}"] = rng.normal(size=n)
    cols = {k: np.asarray(v, np.float32) for k, v in cols.items()}
    plyio.write_ply(str(path), {"vertex": plyio.structured_from_columns(cols)})
    return str(path)


def write_sphere_obj(path, radius=0.5, n_lat=16, n_lon=32, tex=64):
    """A latitude-longitude sphere with its UVs and a smooth colour pattern
    of a few periods as its texture, as OBJ (with .mtl and PNG)."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(la) * np.sin(lo), np.cos(la), np.sin(la) * np.cos(lo)], -1) * radius
    vt = np.stack([lo / (2 * np.pi), 1.0 - la / np.pi], -1)
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    f = np.concatenate([np.stack([a, c, d], 1), np.stack([a, d, b], 1)])
    vf = v.reshape(-1, 3)
    area = np.linalg.norm(np.cross(vf[f[:, 1]] - vf[f[:, 0]], vf[f[:, 2]] - vf[f[:, 0]]), axis=1)
    f = f[area > 1e-9].astype(np.int32)
    yy, xx = np.mgrid[0:1:tex * 1j, 0:1:tex * 1j]
    albedo = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (3 * xx + k) + 5 * yy * k)
                       for k in range(3)], -1).astype(np.float32)
    mesh = Mesh(v=vf.astype(np.float32), f=f, vt=vt.reshape(-1, 2).astype(np.float32), ft=f,
                albedo=albedo)
    mesh.auto_normal()
    mesh.write(str(path))
    return str(path)


def port_runall():
    """``scripts/port_runall.py`` as a module."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "port_runall.py"
    spec = importlib.util.spec_from_file_location("port_runall", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


@pytest.fixture()
def http():
    """``start(handler)`` serves ``handler`` on a free local port in a thread
    and returns its URL; every server is shut down after the test."""
    servers = []

    def start(handler):
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()
