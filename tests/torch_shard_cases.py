"""The port's sharded paths run in real ranks: one process each, joined by
``torch.distributed`` (gloo). Shared by the CPU parity tests and the card
tests; imports no JAX.

A test writes each job's inputs to a folder of its own with
``write_inputs`` and calls ``run_ranks``, which starts ``world`` processes
of this file; each joins one process group and runs the jobs (a case of
``CASES`` and its folder) in order on the given device, writing a job's
results to ``<workdir>/<case>_r<rank>.npz``. Any rank's failure fails the
run, and the other ranks are stopped (``parallel.launch.run_ranks``). One
start serves several jobs: a rank's start (importing torch) costs more
than a small job. As a process:

    python tests/torch_shard_cases.py <tcp://127.0.0.1:port> <world> <rank> <device> <case>=<workdir>...
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256          # the tile-shard renders: 8 tile rows of 32
TILE = 32
# Learning rates of the data-parallel step cases (the JAX tests' LRS).
LRS = {"total_iters": 100.0, "f_dc": 1e-2, "f_rest": 5e-4, "opacity": 0.05,
       "scaling": 5e-3, "rotation": 5e-3}
XYZ_LR = 1e-2


def scene(n: int, seed: int):
    """xyz, scale, quat, opacity, shs of tests/test_tile_shard.py's scene."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        (rng.normal(size=(n, 3)) * 0.35).astype(f),
        np.exp(rng.uniform(-4.2, -2.5, size=(n, 3))).astype(f),
        rng.normal(size=(n, 4)).astype(f),
        (1 / (1 + np.exp(-rng.normal(size=(n,))))).astype(f),
        (rng.normal(size=(n, 1, 3)) * 0.3).astype(f),
    )


def loss_weights(size: int = SIZE) -> np.ndarray:
    return np.random.default_rng(7).normal(size=(size, size, 3)).astype(np.float32)


def write_inputs(workdir: str, arrays: dict, options: dict) -> None:
    """The case's inputs: numpy arrays and JSON options."""
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
    with open(os.path.join(workdir, "options.json"), "w") as f:
        json.dump(options, f)


def run_ranks(jobs: list, world: int, device: str = "cpu", timeout: float = 300.0) -> list:
    """Run the ``(case, workdir)`` jobs, in order, in ``world`` ranks (a rank
    that fails stops the others and raises with their output); returns, for
    each job, each rank's results (dicts of arrays)."""
    from dreamgaussian_tpu_torch.parallel.launch import free_port
    from dreamgaussian_tpu_torch.parallel.launch import run_ranks as run_processes

    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run_processes(lambda r: [sys.executable, os.path.abspath(__file__), init, str(world), str(r),
                             device, *(f"{case}={work}" for case, work in jobs)],
                  world, timeout, env=env)
    out = []
    for case, work in jobs:
        out.append([])
        for r in range(world):
            with np.load(os.path.join(work, f"{case}_r{r}.npz")) as z:
                out[-1].append({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# Cases (run inside a rank)
# ---------------------------------------------------------------------------


def _t(a, device):
    import torch

    return torch.as_tensor(np.asarray(a), device=device)


def _cam(size, device):
    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    fov = math.radians(49.1)
    c = Camera.from_pose(orbit_camera(15, 30, 2.0), size, size, fov, fov).arrays()
    return [_t(c[k], device) for k in ("view", "full_proj", "campos", "tanfov")]


def _render(axis, arrays, device, grad: bool):
    """The tile-shard test's forward (image, depth, alpha) or its gradients
    of sum(image * w) + sum(alpha) (xyz, scale, quat, opacity, shs), over
    ``axis`` or unsharded (None)."""
    import torch

    from dreamgaussian_tpu_torch.ops.rasterize import render_gaussians
    from dreamgaussian_tpu_torch.parallel.tile_shard import render_gaussians_tile_sharded

    args = [_t(a, device).requires_grad_(grad) for a in arrays]
    bg = torch.ones(3, device=device)
    if axis is None:
        out = render_gaussians(*args, *_cam(SIZE, device), SIZE, SIZE, bg, tile=TILE,
                               device=device)
    else:
        out = render_gaussians_tile_sharded(*args, *_cam(SIZE, device), SIZE, SIZE, bg, axis,
                                            tile=TILE)
    if not grad:
        return {"image": out.image, "depth": out.depth, "alpha": out.alpha}
    loss = torch.sum(out.image * _t(loss_weights(), device)) + torch.sum(out.alpha)
    grads = torch.autograd.grad(loss, args)
    return dict(zip(("xyz", "scale", "quat", "opacity", "shs"), grads))


def case_tile_render(rank, world, workdir, device):
    """tile2 (a data2xtile2 mesh) and tile4 renders of the tile-shard
    test's scenes, forward and gradients; rank 0 also renders unsharded."""
    from dreamgaussian_tpu_torch.parallel import make_mesh_2d
    from dreamgaussian_tpu_torch.parallel.tile_shard import make_tile_sharded_render

    meshes = {"tile2": make_mesh_2d(2, 2, device=device), "tile4": make_mesh_2d(1, 4, device=device)}
    if rank == 0:
        meshes["single"] = None
    out = {}
    for label, mesh in meshes.items():
        axis = None if mesh is None else mesh.tile
        for k, v in _render(axis, scene(200, 0), device, grad=False).items():
            out[f"{label}_{k}"] = v
        if mesh is not None:
            render = make_tile_sharded_render(mesh, SIZE, SIZE, tile=TILE)
            out[f"{label}_made_image"] = render(*(_t(a, device) for a in scene(200, 0)),
                                                *_cam(SIZE, device))
        for k, v in _render(axis, scene(120, 3), device, grad=True).items():
            out[f"{label}_g_{k}"] = v
    return out


def _inputs(workdir, device):
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(workdir, "options.json")) as f:
        options = json.load(f)
    return arrays, options


def _group(arrays, prefix, device):
    return {k[len(prefix):]: _t(v, device) for k, v in arrays.items() if k.startswith(prefix)}


def noisy_guidance(images, cond, step_ratio, draw):
    """A guidance that draws: the mean of (image - 0.5 - 0.1 noise)^2 over
    the views given, the noise from ``draw``."""
    import torch

    noise = draw("sds_noise", tuple(images.shape), "normal").to(images.device)
    return torch.mean((images - 0.5 - 0.1 * noise) ** 2)


def plain_guidance(images, cond, step_ratio, draw):
    """tests/test_parallel.py's fake guidance: the mean of (image - 0.5)^2."""
    import torch

    return torch.mean((images - 0.5) ** 2)


class Injected:
    """A ``draw`` answering each name with the given samples in order; the
    init draws (a cloud the caller replaces) with 0.5."""

    def __init__(self, samples: dict):
        self.samples = {k: list(v) for k, v in samples.items()}
        self.names = []

    def __call__(self, name, shape, dist, low=0, high=None):
        import torch

        self.names.append(name)
        if name.startswith("init_"):
            return torch.full(shape, 0.5)
        value = torch.as_tensor(self.samples[name].pop(0))
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: injected {tuple(value.shape)}, asked {tuple(shape)}")
        return value


def case_dp_step(rank, world, workdir, device):
    """``make_dp_train_step`` over a data mesh of every rank for
    ``options["steps"]`` steps from the given state, cameras and noise.
    Returns the losses and the state after each step (the Adam moments
    after the first step hold the reduced gradient)."""
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda
    from dreamgaussian_tpu_torch.parallel import make_data_mesh, make_dp_train_step, shard_cameras
    from dreamgaussian_tpu_torch.scene import GaussianAux, adam_init

    arrays, opt = _inputs(workdir, device)
    mesh = make_data_mesh(device=device)
    params = _group(arrays, "p_", device)
    aux = GaussianAux(**_group(arrays, "aux_", device))
    adam = adam_init(params)
    known = _group(arrays, "known_", device)
    novel = shard_cameras(mesh, _group(arrays, "novel_", device))
    lrs = dict(LRS, xyz=lambda s: XYZ_LR)
    guidance = noisy_guidance if opt["noise"] else plain_guidance
    step = make_dp_train_step(mesh, novel_size=opt["size"], ref_size=opt["size"], sh_degree=0,
                              views_per_device=novel["view"].shape[0], use_known_view=True,
                              warmup_rgb_loss=False, lr_schedules=lrs,
                              guidance_fns=((1.0, guidance),))
    draw = Injected({"sds_noise": arrays["noise"]} if opt["noise"] else {})
    before = dict(rasterize_cuda.LAUNCHES)
    out = {}
    for i in range(opt["steps"]):
        params, adam, aux, metrics = step(
            params, adam, aux, float(i + 1), known, novel, torch.ones(3, device=device),
            _t(arrays["ref_rgb"], device), _t(arrays["ref_mask"], device), draw, {})
        out[f"loss_{i}"] = metrics["loss"]
        if i == 0:
            out.update({f"mu0_{k}": v for k, v in adam.mu.items()})
    for k in ("fwd", "bwd"):
        name = f"composite_{k}"
        out[f"launches_{k}"] = np.asarray(rasterize_cuda.LAUNCHES[name] - before[name])
    out.update({f"p_{k}": v for k, v in params.items()})
    out.update({f"nu_{k}": v for k, v in adam.nu.items()})
    out.update({f"aux_{k}": v for k, v in aux._asdict().items()})
    return out


def case_trainer(rank, world, workdir, device):
    """``Stage1Trainer`` on the mesh of ``options["mesh"]`` with the given
    initial state and split noise, ``options["steps"]`` train_steps with
    the plain guidance; the losses, and every rank's state after each step
    (for the replicas check)."""
    from dreamgaussian_tpu_torch.parallel import make_mesh_2d
    from dreamgaussian_tpu_torch.scene import adam_init
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    arrays, opt = _inputs(workdir, device)
    data, tile = opt["mesh"]
    mesh = make_mesh_2d(data, tile, device=device)
    draw = Injected({"split": arrays["split"]})
    tr = Stage1Trainer(Config(opt["trainer"]), ref_rgb=arrays["ref_rgb"],
                       ref_mask=arrays["ref_mask"], guidance_fns=((1.0, plain_guidance),),
                       capacity=opt["capacity"], seed=opt["seed"], device=device, draw=draw,
                       mesh=mesh)
    tr.params = _group(arrays, "p_", device)
    tr.aux = tr.aux._replace(**_group(arrays, "aux_", device))
    tr.adam = adam_init(tr.params)
    out = {}
    for i in range(opt["steps"]):
        out[f"loss_{i}"] = tr.train_step()
        state = {**{f"p_{k}": v for k, v in tr.params.items()},
                 **{f"mu_{k}": v for k, v in tr.adam.mu.items()},
                 **{f"nu_{k}": v for k, v in tr.adam.nu.items()},
                 **{f"aux_{k}": v for k, v in tr.aux._asdict().items()}}
        out.update({f"s{i}_{k}": v for k, v in state.items()})
    out["draws"] = np.asarray(draw.names.count("split"))
    # JAX's train_step leaves the capacity as it is; the check after the
    # run grows it on every rank alike when densify found no slot.
    out["dropped"] = np.asarray(int(tr.densify_dropped if tr.densify_dropped is not None else 0))
    tr._check_overflow()
    out["capacity"] = np.asarray(tr.capacity)
    return out


def _state(trainer) -> dict:
    """Every array of a trainer's state, its step and both random states."""
    import torch

    return {**{f"p_{k}": v for k, v in trainer.params.items()},
            **{f"mu_{k}": v for k, v in trainer.adam.mu.items()},
            **{f"nu_{k}": v for k, v in trainer.adam.nu.items()},
            **{f"aux_{k}": v for k, v in trainer.aux._asdict().items()},
            "adam_count": np.asarray(int(trainer.adam.count)), "step": np.asarray(trainer.step),
            "np_rng": np.asarray(json.dumps(trainer.rng.bit_generator.state)),
            **({"draw": torch.as_tensor(trainer.draw.get_state())}
               if hasattr(trainer.draw, "get_state") else {})}


def case_resume(rank, world, workdir, device):
    """Resume on a data mesh of every rank with the trainer's own seeded
    draws (a guidance that draws its noise): the unbroken run of
    ``options["iters"]`` steps (``w_``); a run saved at ``options["stop"]``
    (rank 0 writes ``<workdir>/ckpt``) and resumed, through cli.main's
    ``resume_checkpoint``, by rank 0 from that folder and by the other ranks
    from a folder that does not exist (``r_``: the state just after the
    restore; ``f_``: after the remaining steps); and ``resume=True`` where
    rank 0 finds no folder and the other ranks find the checkpoint
    (``d_``); and rank 0's folder without a checkpoint file (``e_error``:
    what each rank raised)."""
    from dreamgaussian_tpu_torch.cli.main import resume_checkpoint
    from dreamgaussian_tpu_torch.parallel import make_mesh_2d
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    arrays, opt = _inputs(workdir, device)
    mesh = make_mesh_2d(world, 1, device=device)

    def trainer():
        return Stage1Trainer(Config(opt["trainer"]), ref_rgb=arrays["ref_rgb"],
                             ref_mask=arrays["ref_mask"], guidance_fns=((1.0, noisy_guidance),),
                             capacity=opt["capacity"], seed=opt["seed"], device=device, mesh=mesh)

    ckpt, iters, stop = os.path.join(workdir, "ckpt"), opt["iters"], opt["stop"]
    whole = trainer()
    whole.train(iters, log_every=0)
    out = {f"w_{k}": v for k, v in _state(whole).items()}
    trainer().train(stop, log_every=0, checkpoint_every=stop, checkpoint_dir=ckpt)
    resumed = trainer()
    found = resume_checkpoint(Config({"resume": True, "checkpoint_dir": ckpt if rank == 0 else
                                      os.path.join(workdir, f"absent_{rank}")}), resumed)
    out["r_found"] = np.asarray(found)
    out.update({f"r_{k}": v for k, v in _state(resumed).items()})
    resumed.train(iters - resumed.step, log_every=0)
    out.update({f"f_{k}": v for k, v in _state(resumed).items()})
    fresh = trainer()
    found = resume_checkpoint(Config({"resume": True, "checkpoint_dir": ckpt if rank else
                                      os.path.join(workdir, "absent_0")}), fresh)
    out["d_found"], out["d_step"] = np.asarray(found), np.asarray(fresh.step)
    # A folder without the file on rank 0: rank 0 says so and every rank raises.
    empty = os.path.join(workdir, "empty")
    os.makedirs(empty, exist_ok=True)
    try:
        resume_checkpoint(Config({"resume": True, "checkpoint_dir": empty}), trainer())
        out["e_error"] = np.asarray("")
    except RuntimeError as e:
        out["e_error"] = np.asarray(str(e))
    return out


def case_trainer_leg(rank, world, workdir, device):
    """One leg of a run switched between meshes: ``Stage1Trainer`` on the
    mesh of ``options["mesh"]`` with the plain guidance and the given split
    draws, from the given cloud or restored from ``options["load"]``;
    ``options["steps"]`` train_steps, then a checkpoint to
    ``options["save"]`` when given (rank 0 writes it). Returns the losses
    and the final state."""
    from dreamgaussian_tpu_torch.parallel import make_mesh_2d
    from dreamgaussian_tpu_torch.scene import adam_init
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    arrays, opt = _inputs(workdir, device)
    mesh = make_mesh_2d(*opt["mesh"], device=device)
    tr = Stage1Trainer(Config(opt["trainer"]), ref_rgb=arrays["ref_rgb"],
                       ref_mask=arrays["ref_mask"], guidance_fns=((1.0, plain_guidance),),
                       capacity=opt["capacity"], seed=opt["seed"], device=device,
                       draw=Injected({"split": arrays["split"]}), mesh=mesh)
    if opt.get("load"):
        tr.load_checkpoint(opt["load"])
    else:
        tr.params = _group(arrays, "p_", device)
        tr.aux = tr.aux._replace(**_group(arrays, "aux_", device))
        tr.adam = adam_init(tr.params)
    out = {f"loss_{i}": tr.train_step() for i in range(opt["steps"])}
    if opt.get("save") and tr.is_writer:
        tr.save_checkpoint(opt["save"])
    out.update(_state(tr))
    return out


CASES = {"tile_render": case_tile_render, "dp_step": case_dp_step, "trainer": case_trainer,
         "resume": case_resume, "trainer_leg": case_trainer_leg}


def main(argv) -> None:
    init, world, rank, device, *jobs = argv
    world, rank = int(world), int(rank)
    import torch
    import torch.distributed as dist

    from dreamgaussian_tpu_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    backend = initialize_multihost(init_method=init, world_size=world, rank=rank, device=device)
    for job in jobs:
        case, workdir = job.split("=", 1)
        out = CASES[case](rank, world, workdir, device)
        np.savez(os.path.join(workdir, f"{case}_r{rank}.npz"),
                 **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in out.items()})
        print(f"[rank {rank}] {case} done on {device} ({backend})")
    if backend is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
