"""The reference agrees with the port at tiny sizes on the CPU: the render
(image, alpha and every parameter's gradient) against the port's
``render_gaussians``, and whole compared steps of each cell with the port's
networks in float32 (the port's bfloat16 is the only difference the
limits allow for)."""

import math

import numpy as np
import pytest
import torch

from portbench import harness, inputs, run
from portbench.reference import render
from portbench.tests import tiny

BENCH = harness.benchmark()


def test_render_and_gradients_match_the_port():
    from dreamgaussian_tpu_torch.ops.rasterize import render_gaussians

    size = 64
    cloud = {k: torch.from_numpy(v) for k, v in inputs.cloud(5, 300).items()}
    alive = torch.ones(300, dtype=torch.bool)
    alive[::7] = False
    cam = {k: torch.from_numpy(v) for k, v in render.camera_arrays(
        render.orbit_pose(10.0, 35.0, 2.0), math.radians(49.1)).items()}
    bg = torch.tensor([1.0, 1.0, 1.0])
    w = torch.randn(size, size, 3, generator=torch.Generator().manual_seed(1))

    p_port = {k: v.clone().requires_grad_(True) for k, v in cloud.items()}
    out = render_gaussians(p_port["xyz"], torch.exp(p_port["scaling"]), p_port["rotation"],
                           torch.sigmoid(p_port["opacity"][:, 0]),
                           torch.cat([p_port["f_dc"], p_port["f_rest"]], 1), cam["view"],
                           cam["full_proj"], cam["campos"], cam["tanfov"], size, size, bg,
                           alive=alive, tile=32, device="cpu")
    ((out.image * w).sum() + out.alpha.sum()).backward()

    p_ref = {k: v.clone().requires_grad_(True) for k, v in cloud.items()}
    r = render.Render(p_ref, alive, cam, size, bg)
    image = render.clamp_tie(r.image, 0.0, 1.0)
    ((image * w).sum() + r.alpha.sum()).backward()
    r.backward()
    # float32 compositing in another order (cumprod against the kernels'
    # sequential walk) and projection arithmetic: agree to 1e-4.
    assert torch.allclose(image, out.image, atol=1e-4)
    assert torch.allclose(r.alpha, out.alpha, atol=1e-4)
    for k in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        g_port, g_ref = p_port[k].grad, p_ref[k].grad
        assert torch.allclose(g_ref, g_port, rtol=1e-3, atol=1e-4 * float(g_port.abs().max())), k


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_compared_steps_match_the_port_in_float32(name):
    cell = harness.cell(BENCH, name)
    cfg = tiny.config(cell["config"])
    cfg["precision"]["guidance_networks"] = "float32"
    line = run.run_cell(BENCH, cell, cfg, tiny.traffic(cell["traffic"]), 2**35 + 3, 0.2, False,
                        device="cpu")
    assert line["correct"]
    # In float32 on both sides the gaps are rounding: a tenth of the limits
    # (set for the port's bfloat16 networks) at most.
    for k, c in line["checks"].items():
        assert c["value"] < c["limit"] / 10, (k, c)
    step_metric = "refine_step_ms" if "refine" in name else "stage1_step_ms"
    assert np.isfinite(line["metrics"][step_metric]["value"])
