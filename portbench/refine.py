"""Runner of the stage-2 cells (traffic kind ``refine``).

Set-up builds the port's guidance on the run's weights (the same object a
stage-1 cell builds; its ``refine_fn`` is the DDIM img2img), the mesh and
its albedo and the reference view from the seed (``inputs.py``), and a
first ``Stage2Trainer`` (job 0) on the configuration's options with the
run's ``Draws``: its first ``COMPARED_STEPS`` steps are the ones the
reference follows; ``warmup_steps`` more, and on until the job's draws
have rendered at every SSAA side, warm up the shapes.

The window runs whole jobs back to back, each a fresh ``Stage2Trainer``
on the same mesh and guidance (a user's ``cli.main2`` run, its seed the
job's), ``iters_refine`` steps each with the strength going 0.8 -> 0.95
(10 -> 3 UNet calls): at least ``min_jobs``, and another while the jobs so
far, with one more of their mean length, stay within ``--seconds``. The
window ends with the last job's last step (then a synchronisation), so it
holds whole jobs only. A CUDA event after each step gives the step times.
Traced runs set the trainer's ``phase_timing`` (a synchronisation on both
sides of each phase) for the window's first job, and trace ``trace_steps``
steps of it from step ``trace_from`` on (near the
job's mean UNet calls) under the profiler; the z-test work of their
renders is counted after the window by the reference's plain visibility
on the same cameras.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from . import inputs, work
from .reference import guidance as ref_guidance
from .reference import mesh as mesh_ops
from .reference import precision, render
from .reference.stage1 import ADAM_B1
from .reference.stage2 import SSAA_CHOICES, Stage2
from .stage1 import (COMPARED_STEPS, STEP_SPAN, Marks, _sync, build_guidance, compare, leaf_gaps,
                     peak_bytes)


def unet_calls(step: int, iters: int, steps: int = 50) -> int:
    """UNet calls of a refine step: the DDIM steps from the strength's
    start to the end."""
    strength = np.float32(min(1.0, step / iters) * 0.15 + 0.8)
    return steps - ref_guidance.refine_start(steps, strength)


def job_flops(arch: dict, iters: int) -> int:
    """A job's model operations: every step's UNet calls at the CFG batch,
    its VAE encode and decode at the guidance side."""
    side = arch["image_size"]
    unet = work.unet_flops(arch, 2, camera=False)
    vae = work.vae_flops(arch, 1, side, "encode") + work.vae_flops(arch, 1, side, "decode")
    return sum(unet_calls(s, iters) * unet + vae for s in range(1, iters + 1))


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.trace = trace
        self.opt = dict(config["trainer"], batch_size=traffic["batch_size"])
        self.ctx = {"kind": "refine"}

    def mesh_sizes(self) -> dict:
        m = self.config["mesh"]
        return {"nlat": m["lat"], "nlon": m["lon"], "texture": m["texture"]}

    def job_seed(self, job: int) -> int:
        return (inputs.stream_seed(self.seed, "order") + job) % 2**63

    def trainer(self, job: int):
        from dreamgaussian_tpu_torch.meshing.mesh import Mesh
        from dreamgaussian_tpu_torch.train import Stage2Trainer

        m = self.mesh
        mesh = Mesh(v=m["v"].copy(), f=m["f"].copy(), vn=m["vn"].copy(), vt=m["vt"].copy(),
                    ft=m["ft"].copy(), albedo=m["albedo"].copy())
        return Stage2Trainer(self.opt, mesh, ref_rgb=self.ref_rgb, refine_fns=self.refine_fns,
                             seed=self.job_seed(job), refine_image_size=self.image_size,
                             device=self.device, draw=self.draws)

    def setup(self) -> None:
        cfg, dev = self.config, self.device
        self.image_size = cfg["arch"]["image_size"]
        self.size = self.opt.get("novel_resolution", 512)
        self.draws = inputs.Draws(self.seed, dev)
        self.guidance = build_guidance(cfg, self.seed, dev)
        self.refine_fns = ((cfg["guidance_weight"],
                            self.guidance.refine_fn(steps=self.opt.get("refine_steps", 50))),)
        self.mesh = inputs.mesh(self.seed, **self.mesh_sizes())
        self.ref_rgb, _ = inputs.reference_view(self.seed, self.opt["ref_size"])
        tr = self.trainer(0)
        p0 = tr.params["raw_albedo"].clone()
        losses = []
        for i in range(COMPARED_STEPS):
            losses.append(float(tr.train_step()))
            if i == 0:
                g1 = tr.adam.mu["raw_albedo"] / (1.0 - ADAM_B1)
        self.port_steps = {"loss": losses, "grad": {"raw_albedo": g1},
                     "change": {"raw_albedo": tr.params["raw_albedo"] - p0}}
        self.draws.recording = False
        # Warm up at least ``warmup_steps`` more, and on until every SSAA
        # side has been rendered (the job's draws, replayed), so that no
        # kernel is first loaded inside the window.
        cams = np.random.default_rng(self.job_seed(0))
        seen = {_draw_cameras(cams, self.opt)[0] for _ in range(COMPARED_STEPS)}
        for n in range(self.opt.get("iters_refine", 50) - COMPARED_STEPS):
            if n >= self.traffic["warmup_steps"] and len(seen) == len(SSAA_CHOICES):
                break
            seen.add(_draw_cameras(cams, self.opt)[0])
            tr.train_step()
        _sync(dev)
        self.jobs_done = 1

    def window(self, seconds: float) -> None:
        import time

        from torch.profiler import record_function

        from . import trace

        dev, opt = self.device, self.opt
        iters = opt.get("iters_refine", 50)
        setup_peak = peak_bytes(dev, reset=True)
        if self.trace:
            opt["phase_timing"] = True
        marks, phases, jobs, renders = Marks(dev), [], 0, []
        _sync(dev)
        t0 = time.perf_counter()
        marks.mark()
        while jobs < self.traffic["min_jobs"] or (
                time.perf_counter() - t0) * (jobs + 1) / jobs <= seconds:
            job = self.jobs_done + jobs
            tr = self.trainer(job)
            cams = np.random.default_rng(self.job_seed(job))

            def step(i, tr=tr, cams=cams):
                ssaa, _, _, poses = _draw_cameras(cams, opt)
                for p in poses:
                    renders.extend([(p, 1.0 * self.image_size / self.size, True),
                                    (p, ssaa, True)])
                renders.append((render.orbit_pose(opt.get("elevation", 0.0), 0.0,
                                                  opt.get("radius", 2.0)), 1.0, False))
                with record_function(STEP_SPAN):
                    tr.train_step()
                marks.mark()

            s = 0
            while s < iters:
                if self.trace and jobs == 0 and s == self.traffic["trace_from"] - 1:
                    renders.clear()
                    n = self.traffic["trace_steps"]
                    self.ctx["trace"] = trace.profile_stretch(step, n)
                    self.ctx["trace"].update(steps=n, renders=list(renders))
                    s += n
                    continue
                if self.trace and jobs == 0:
                    _draw_cameras(cams, opt)
                tr.train_step()
                marks.mark()
                s += 1
            phases += tr.phase_times
            opt["phase_timing"] = False
            jobs += 1
        _sync(dev)
        window_s = time.perf_counter() - t0
        opt["phase_timing"] = False
        self.jobs_done += jobs
        window_peak = peak_bytes(dev)
        self.ctx.update(window_s=window_s, steps=jobs * iters, jobs=jobs,
                        step_ms_each=marks.step_ms(), window_peak_bytes=window_peak,
                        memory_peak_bytes=max(setup_peak, window_peak))
        if phases:
            self.ctx["phase_s"] = phases

    def count_work(self) -> None:
        """The z-test work of the traced steps' renders (the reference's
        plain visibility on the same cameras and sides) and the job's
        model operations per step."""
        opt, dev = self.opt, self.device
        t = self.ctx["trace"]
        v = torch.from_numpy(self.mesh["v"]).to(dev)
        f = torch.from_numpy(self.mesh["f"]).long().to(dev)
        fovy = math.radians(opt.get("fovy", 49.1))
        bound = 0.0
        for pose, ssaa, novel in t.pop("renders"):
            cam = render.camera_arrays(pose, fovy)
            s = mesh_ops.ssaa_side(self.size if novel else opt["ref_size"], ssaa)
            v_clip = torch.cat([v, torch.ones_like(v[:, :1])], 1) @ torch.from_numpy(
                cam["full_proj"]).to(dev).T
            bound += work.k3_bound_s(mesh_ops.visibility(v_clip, f, s, s)[2])
        t["k3_bound_s"] = bound
        iters = opt.get("iters_refine", 50)
        self.ctx["flops_per_step"] = job_flops(self.config["arch"], iters) / iters

    def after(self) -> None:
        if self.trace:
            self.count_work()
        self.free()
        self.ctx["gaps"] = compare(self.port_steps, self.reference())

    def reference(self, control: bool = False) -> dict:
        cfg, opt, dev = self.config, self.opt, self.device
        arch = cfg["arch"]
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            unet, vae = inputs.reference_nets(arch)
            weights = inputs.guidance_weights(arch, self.seed, dev)
            unet.load_state_dict({k: v.float() for k, v in weights["unet"].items()}, assign=True)
            vae.load_state_dict({k: v.float() for k, v in weights["vae"].items()}, assign=True)
            del weights
            unet.eval().requires_grad_(False)
            vae.eval().requires_grad_(False)
            if control:
                precision.fp8_control(unet)
                precision.fp8_control(vae)
            sds = ref_guidance.SDS(arch["kind"], unet, vae,
                                   inputs.states(arch["kind"], arch, self.seed, dev), self.image_size)
            m = {k: torch.from_numpy(v).to(dev)
                 for k, v in inputs.mesh(self.seed, **self.mesh_sizes()).items()}
            m["f"], m["ft"] = m["f"].long(), m["ft"].long()
            rgb, _ = inputs.reference_view(self.seed, opt["ref_size"])
            ref = Stage2(opt, m, m.pop("albedo"), torch.from_numpy(rgb).to(dev),
                         ref_guidance.Refine(sds, opt.get("refine_steps", 50)),
                         cfg["guidance_weight"], np.random.default_rng(self.job_seed(0)),
                         iter(self.draws.record), self.image_size)
            raw0 = ref.raw_albedo.clone()
            losses = []
            for i in range(COMPARED_STEPS):
                losses.append(ref.train_step())
                if i == 0:
                    g1 = ref.first_gradient()
            return {"loss": losses, "grad": {"raw_albedo": g1},
                    "change": {"raw_albedo": ref.raw_albedo - raw0}}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def leave(self) -> None:
        self.free()

    def free(self) -> None:
        """Drop the port's state before the reference runs."""
        self.guidance = self.refine_fns = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _draw_cameras(rng, opt):
    """A stage-2 step's draws from its job's generator: the SSAA factor,
    then the orbit sample."""
    ssaa = SSAA_CHOICES[int(rng.integers(0, len(SSAA_CHOICES)))]
    vers, hors, poses = render.sample_orbit(rng, opt, opt.get("batch_size", 1), 1)
    return ssaa, vers, hors, poses


__all__ = ["Run", "compare", "leaf_gaps"]
