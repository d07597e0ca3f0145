"""Multi-process data parallelism of the PyTorch port: two gloo processes
with two views each against the port on one 4-rank group with a view each,
and both against JAX's 4-device data mesh (tests/test_multihost.py's step
stream: the same cloud, cameras and three steps)."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dreamgaussian_tpu.parallel import make_dp_train_step
from dreamgaussian_tpu.parallel.dp import shard_cameras
from dreamgaussian_tpu.scene import adam_init, init_random
from tests.multihost_common import LRS, N_STEPS, fake_guidance, make_inputs
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import run_ranks, write_inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two- and four-rank runs, started first, and JAX's
    4-device mesh run while they go."""
    params, aux = init_random(jax.random.PRNGKey(0), num_pts=128, capacity=256)
    known, novel, ref_rgb, ref_mask, keys = make_inputs()
    arrays = {**{f"p_{k}": np.asarray(v) for k, v in params.items()},
              **{f"aux_{k}": np.asarray(v) for k, v in aux._asdict().items()},
              **{f"known_{k}": np.asarray(v) for k, v in known.items()},
              **{f"novel_{k}": v for k, v in novel.items()},
              "ref_rgb": np.asarray(ref_rgb), "ref_mask": np.asarray(ref_mask)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ports = {}
        for world in (2, 4):
            work = str(tmp_path_factory.mktemp(f"multihost{world}"))
            write_inputs(work, arrays, {"size": 32, "steps": N_STEPS, "noise": False})
            ports[world] = pool.submit(run_ranks, [("dp_step", work)], world)

        mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
        step = make_dp_train_step(mesh, novel_size=32, ref_size=32, sh_degree=0,
                                  views_per_device=1, use_known_view=True,
                                  warmup_rgb_loss=False, lr_schedules=LRS,
                                  guidance_fns=((1.0, fake_guidance),))
        p, a, x = params, adam_init(params), aux
        losses = []
        for i, key in enumerate(keys):
            p, a, x, m = step(p, a, x, jnp.float32(i + 1.0), known, shard_cameras(mesh, novel),
                              jnp.ones(3), ref_rgb, ref_mask, jnp.asarray(key), {})
            losses.append(float(m["loss"]))
        jax_out = {"losses": np.asarray(losses), "xyz": np.asarray(p["xyz"]),
                   "opacity": np.asarray(p["opacity"])}
        out = {world: f.result()[0] for world, f in ports.items()}
    return out, jax_out


def _losses(rank):
    return np.asarray([float(rank[f"loss_{i}"]) for i in range(N_STEPS)])


def test_two_processes_match_four_ranks(runs):
    """Two views a rank on two ranks, one on four: the same global mean.
    tests/test_multihost.py's bounds (losses 1e-5, parameters 1e-6)."""
    ports, _ = runs
    for two in ports[2]:
        for four in ports[4]:
            np.testing.assert_allclose(_losses(two), _losses(four), rtol=1e-5)
            np.testing.assert_allclose(two["p_xyz"], four["p_xyz"], atol=1e-6)
            np.testing.assert_allclose(two["p_opacity"], four["p_opacity"], atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_port_matches_jax_four_device_mesh(runs, world):
    ports, ref = runs
    for rank in ports[world]:
        np.testing.assert_allclose(_losses(rank), ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["p_xyz"], ref["xyz"], atol=1e-6)
        np.testing.assert_allclose(rank["p_opacity"], ref["opacity"], atol=1e-6)
