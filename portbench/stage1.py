"""Runner of the stage-1 cells (traffic kind ``stage1``).

Set-up builds the port's pieces from the run's inputs (``inputs.py``): the
guidance networks with the seeded weights, the prior's guidance object
(``guidance.sds``), and one ``Stage1Trainer`` on the configuration's
options whose start cloud comes in through the trainer's ``load`` path (a
PLY written to ``TMPDIR``) at the configuration's capacity, with the run's
``Draws`` as its random numbers. The trainer's step counter is set so that
its first step is the mix's ``start_step``. The first ``COMPARED_STEPS``
steps are the ones the reference follows; with ``warmup_steps`` more they
warm up every shape the window uses (a densify step among them).

The window calls ``train_step`` until ``--seconds`` have passed on the
host clock, with a CUDA event recorded on the stream after each step and
no synchronisation, then synchronises: the mean step time is the whole
window over its steps, and each step's time is the gap between its event
and the one before. With ``--trace 1`` the guidance callable handed to the
trainer is wrapped in a host span (``portbench.guidance``) during the
window, and after it a stretch of ``trace_steps`` steps runs under the
profiler (``trace.py``); the compositing work of the stretch's renders is
counted by the reference's plain compositing on the parameters each step
started from.

Then the port's state is freed and the reference (``reference/``)
follows the compared steps from the same inputs; ``compare`` reads the
gaps.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from . import inputs, work
from .reference import guidance as ref_guidance
from .reference import precision, render
from .reference.stage1 import ADAM_B1, LEAVES, Stage1, rung

COMPARED_STEPS = 3
GUIDANCE_SPAN = "portbench.guidance"
STEP_SPAN = "portbench.step"
# Leaves whose first gradient in the reference is under this share of the
# median leaf's move under Adam by round-off alone: their change is not
# compared.
STILL_LEAF = 1e-3


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Marks:
    """Step boundaries: a CUDA event recorded on the stream (no
    synchronisation) on a card, the host clock on the CPU (the tests)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            self.marks.append(torch.cuda.Event(enable_timing=True))
            self.marks[-1].record()
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        """The gaps between consecutive marks, in ms (after a sync)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def peak_bytes(dev, reset: bool = False) -> int:
    """The allocator's peak since the last reset (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return peak


def _write_ply(path: str, cloud: dict) -> None:
    """The cloud as a binary little-endian GS PLY (float32 columns)."""
    n = cloud["xyz"].shape[0]
    cols = [("x", cloud["xyz"][:, 0]), ("y", cloud["xyz"][:, 1]), ("z", cloud["xyz"][:, 2])]
    cols += [(k, np.zeros(n, np.float32)) for k in ("nx", "ny", "nz")]
    cols += [(f"f_dc_{i}", cloud["f_dc"][:, 0, i]) for i in range(3)]
    cols += [("opacity", cloud["opacity"][:, 0])]
    cols += [(f"scale_{i}", cloud["scaling"][:, i]) for i in range(3)]
    cols += [(f"rot_{i}", cloud["rotation"][:, i]) for i in range(4)]
    arr = np.empty(n, dtype=[(k, "<f4") for k, _ in cols])
    for k, v in cols:
        arr[k] = v
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k, _ in cols] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())


class Spanned:
    """The guidance callable with a host span around each call while
    ``on`` (no synchronisation added)."""

    def __init__(self, fn):
        self.fn, self.on, self.spans = fn, False, []

    def __call__(self, *args):
        if not self.on:
            return self.fn(*args)
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(GUIDANCE_SPAN):
            out = self.fn(*args)
        self.spans.append(time.perf_counter() - t)
        return out


def trainer_options(config: dict, traffic: dict) -> dict:
    opt = dict(config["trainer"])
    opt["batch_size"] = traffic["batch_size"]
    return opt


def n_views(config: dict) -> int:
    return 4 if config["arch"]["kind"] == "mvdream" else 1


def build_guidance(config: dict, seed: int, device):
    """The port's guidance object on the run's weights and states."""
    from dreamgaussian_tpu_torch.guidance.sds import MVDreamGuidance, Zero123Guidance
    from dreamgaussian_tpu_torch.guidance.unet import UNet, UNetConfig
    from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    arch = config["arch"]
    weights = inputs.guidance_weights(arch, seed, device)
    dtype = getattr(torch, config["precision"]["guidance_networks"])
    with torch.device("meta"):
        unet = UNet(UNetConfig(**arch["unet"])).to(dtype)
        vae = AutoencoderKL(VAEConfig(**arch["vae"])).to(dtype)
    unet.load_state_dict({k: v.to(dtype) for k, v in weights["unet"].items()}, assign=True)
    vae.load_state_dict({k: v.to(dtype) for k, v in weights["vae"].items()}, assign=True)
    unet.eval().requires_grad_(False)
    vae.eval().requires_grad_(False)
    st = inputs.states(arch["kind"], arch, seed, device)
    if arch["kind"] == "zero123":
        return Zero123Guidance(unet, vae, clip_emb=st["clip_emb"], vae_latent=st["vae_latent"],
                               cam_proj=(st["cam_proj_w"], st["cam_proj_b"]),
                               image_size=arch["image_size"])
    return MVDreamGuidance(unet, vae, {"pos": st["text_pos"], "neg": st["text_neg"]},
                           image_size=arch["image_size"])


class Run:
    """One run of a stage-1 cell: ``setup``, ``window``, ``stretch``,
    ``reference``. Readings accumulate in ``ctx``.

    A mix with ``ranks`` > 1 runs on a data mesh, one process per rank
    (``ranks.py`` starts them): ``rank`` is this one's, ``port`` the
    rendezvous on localhost. The ranks agree when the window ends through
    a host-side (gloo) flag that rank 0 sets, so no device synchronisation
    is added; rank 0 alone traces, counts and runs the reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool,
                 rank: int = 0, port: int | None = None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.world = traffic.get("ranks", 1)
        self.rank, self.port = rank, port
        dev = torch.device(device)
        self.device = torch.device("cuda", rank) if dev.type == "cuda" and self.world > 1 else dev
        self.traced = trace
        self.trace = trace and rank == 0
        self.opt = trainer_options(config, traffic)
        self.trainer_seed = inputs.stream_seed(seed, "order")
        self.ctx = {"kind": "stage1", "views": traffic["batch_size"] * n_views(config)}
        self.mesh = self.flags = None

    def join(self) -> None:
        """Join the data mesh of the mix's ranks (the port's process groups)."""
        import torch.distributed as dist

        from dreamgaussian_tpu_torch.parallel.multihost import initialize_multihost, make_mesh_2d

        initialize_multihost(f"tcp://localhost:{self.port}", self.world, self.rank,
                             device=self.device)
        self.mesh = make_mesh_2d(self.world, 1, device=self.device)
        self.flags = dist.new_group(backend="gloo")

    def agree(self, value: float, op: str = "max") -> float:
        """``value`` reduced over the ranks on the host (itself on one)."""
        if self.flags is None:
            return value
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.flags)
        return float(t[0])

    def barrier(self) -> None:
        if self.flags is not None:
            import torch.distributed as dist

            dist.barrier(group=self.flags)

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from dreamgaussian_tpu_torch.train import Stage1Trainer

        cfg, opt, dev = self.config, self.opt, self.device
        arch = cfg["arch"]
        if self.world > 1:
            self.join()
        self.draws = inputs.Draws(self.seed, dev)
        self.guidance = build_guidance(cfg, self.seed, dev)
        fn = Spanned(self.guidance.guidance_fn()) if self.trace else self.guidance.guidance_fn()
        self.spanned = fn if self.trace else None
        capacity = opt["capacity"]
        cloud = inputs.cloud(self.seed, capacity)
        rgb = mask = None
        if arch["kind"] == "zero123":
            rgb, mask = inputs.reference_view(self.seed, opt["ref_size"])
        folder = tempfile.mkdtemp(prefix="portbench-")
        ply = os.path.join(folder, "start.ply")
        try:
            _write_ply(ply, cloud)
            self.trainer = Stage1Trainer(dict(opt, load=ply), ref_rgb=rgb, ref_mask=mask,
                                         guidance_fns=((cfg["guidance_weight"], fn),),
                                         capacity=capacity, seed=self.trainer_seed, device=dev,
                                         draw=self.draws, mesh=self.mesh)
        finally:
            os.remove(ply)
            os.rmdir(folder)
        tr = self.trainer
        tr.step = self.traffic["start_step"] - 1
        p0 = {k: v.clone() for k, v in tr.params.items()}
        losses = []
        for i in range(COMPARED_STEPS):
            losses.append(float(tr.train_step()))
            if i == 0:
                g1 = {k: v / (1.0 - ADAM_B1) for k, v in tr.adam.mu.items()}
        self.port_steps = {"loss": losses, "grad": g1,
                           "change": {k: tr.params[k] - p0[k] for k in LEAVES}}
        self.draws.recording = False
        for _ in range(self.traffic["warmup_steps"]):
            tr.train_step()
        _sync(dev)
        self.steps_done = COMPARED_STEPS + self.traffic["warmup_steps"]

    # -- the window ---------------------------------------------------------

    def window(self, seconds: float) -> None:
        tr, dev = self.trainer, self.device
        setup_peak = peak_bytes(dev, reset=True)
        if self.spanned is not None:
            self.spanned.on = True
        marks = Marks(dev)
        _sync(dev)
        self.barrier()
        t0 = time.perf_counter()
        marks.mark()
        while not self.agree(self.rank == 0 and time.perf_counter() - t0 >= seconds):
            tr.train_step()
            marks.mark()
        _sync(dev)
        self.barrier()
        window_s = time.perf_counter() - t0
        if self.spanned is not None:
            self.spanned.on = False
        step_ms = marks.step_ms()
        window_peak = self.agree(peak_bytes(dev))
        self.steps_done += len(step_ms)
        self.ctx.update(window_s=window_s, steps=len(step_ms), step_ms_each=step_ms,
                        window_peak_bytes=window_peak,
                        memory_peak_bytes=self.agree(max(setup_peak, window_peak)))
        if self.spanned is not None:
            self.ctx["guidance_host_s"] = list(self.spanned.spans)

    # -- the traced stretch -------------------------------------------------

    def stretch(self) -> None:
        from torch.profiler import record_function

        from . import trace

        tr, opt, dev = self.trainer, self.opt, self.device
        n = self.traffic["trace_steps"]
        if not self.trace:
            for _ in range(n):
                tr.train_step()
            _sync(dev)
            return
        cams = Cameras(self.trainer_seed, opt, self.traffic["batch_size"], n_views(self.config))
        per = self.ctx["views"] // self.world
        cams.skip(self.steps_done)
        renders = []
        self.spanned.on = True

        def step(i):
            size = rung(opt, self.traffic["start_step"] + self.steps_done + i)
            snap = ({k: v.detach().clone() for k, v in tr.params.items()}, tr.aux.alive.clone())
            _, _, poses, _ = cams.next()
            poses = poses[self.rank * per:(self.rank + 1) * per]
            if self.config["arch"]["kind"] == "zero123":
                renders.append((snap, render.orbit_pose(opt.get("elevation", 0.0), 0.0,
                                                        opt.get("radius", 2.0)), opt["ref_size"]))
            renders.extend((snap, p, size) for p in poses)
            with record_function(STEP_SPAN):
                tr.train_step()

        summary = trace.profile_stretch(step, n, spans=(GUIDANCE_SPAN,))
        self.spanned.on = False
        self.steps_done += n
        fovy = math.radians(opt.get("fovy", 49.1))
        counts = []
        for (params, alive), pose, size in renders:
            cam = {k: torch.from_numpy(v).to(dev)
                   for k, v in render.camera_arrays(pose, fovy).items()}
            counts.append(render.pair_counts(params, alive, cam, size))
        summary["k1_bound_s"] = sum(work.k1_bound_s(c) for c in counts)
        summary["k2_bound_s"] = sum(work.k2_bound_s(c) for c in counts)
        summary["steps"] = n
        self.ctx["trace"] = summary
        self.ctx["flops_per_step"] = work.stage1_step_flops(self.config["arch"], self.ctx["views"])

    def after(self) -> None:
        """After the window: the traced stretch (traced runs; every rank
        steps, rank 0 traces), then the port's state freed, the reference
        and the comparison (rank 0)."""
        if self.traced:
            self.stretch()
        port = self.port_steps
        self.leave()
        if self.rank == 0:
            self.ctx["gaps"] = compare(port, self.reference())

    def leave(self) -> None:
        """Free the port's state and leave the data mesh."""
        self.free()
        if self.world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()

    def free(self) -> None:
        """Drop the port's state before the reference runs."""
        for name in ("trainer", "guidance", "spanned"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------

    def reference(self, control: bool = False) -> dict:
        """The reference's compared steps from the run's inputs: losses, the
        first gradient, the change. ``control`` runs its networks in fp8."""
        cfg, opt, dev = self.config, self.opt, self.device
        arch = cfg["arch"]
        prev_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
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
                                   inputs.states(arch["kind"], arch, self.seed, dev),
                                   arch["image_size"])
            capacity = opt["capacity"]
            p0 = {k: torch.from_numpy(v).to(dev) for k, v in inputs.cloud(self.seed, capacity).items()}
            rgb = mask = None
            if arch["kind"] == "zero123":
                rgb, mask = (torch.from_numpy(a).to(dev)
                             for a in inputs.reference_view(self.seed, opt["ref_size"]))
            ref = Stage1(opt, p0, torch.ones(capacity, dtype=torch.bool, device=dev), rgb, mask,
                         sds, cfg["guidance_weight"], np.random.default_rng(self.trainer_seed),
                         iter(self.draws.record), self.traffic["start_step"] - 1,
                         n_views(cfg), self.traffic["batch_size"], ranks=self.world)
            losses = []
            for i in range(COMPARED_STEPS):
                losses.append(ref.train_step())
                if i == 0:
                    g1 = {k: v / (1.0 - ADAM_B1) for k, v in ref.mu.items()}
            return {"loss": losses, "grad": g1,
                    "change": {k: ref.params[k] - p0[k] for k in LEAVES}}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32


class Cameras:
    """The trainer's camera draws, replayed from its seed: per step the
    orbit sample (``render.sample_orbit``) and the background draw."""

    def __init__(self, seed: int, opt: dict, batch: int, views: int):
        self.rng = np.random.default_rng(seed)
        self.opt, self.batch, self.views = opt, batch, views

    def next(self):
        vers, hors, poses = render.sample_orbit(self.rng, self.opt, self.batch, self.views)
        white = self.rng.random() > self.opt.get("invert_bg_prob", 0.5)
        return vers, hors, poses, white

    def skip(self, steps: int) -> None:
        for _ in range(steps):
            self.next()


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tree.items() if v.numel()}


def worst_leaf(got: dict, want: dict, leaves) -> float:
    """The largest |norm(got) - norm(want)| over ``leaves``, each against
    the larger of its own reference norm and the median leaf's."""
    g, w = leaf_norms(got), leaf_norms(want)
    median = statistics.median(w[k] for k in leaves)
    return max(abs(g[k] - w[k]) / max(w[k], median) for k in leaves)


def leaf_gaps(port: dict, ref: dict) -> dict:
    """Per leaf: the reference's norms of the first gradient and of the
    change, and each side's gap (for the readings)."""
    out = {}
    for part in ("grad", "change"):
        g, w = leaf_norms(port[part]), leaf_norms(ref[part])
        out[part] = {k: {"reference": w[k], "port": g[k]} for k in w}
    return out


def compare(port: dict, ref: dict) -> dict:
    """The compared numbers: the worst relative loss gap over the compared
    steps, the worst leaf's gap of the first gradient's norm, and the worst
    moving leaf's gap of the norm of the change over the compared steps."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(port["loss"], ref["loss"]))
    g_ref = leaf_norms(ref["grad"])
    leaves = sorted(g_ref)
    median_g = statistics.median(g_ref.values())
    moving = [k for k in leaves if g_ref[k] >= STILL_LEAF * median_g]
    return {"loss_gap": loss, "grad_gap": worst_leaf(port["grad"], ref["grad"], leaves),
            "change_gap": worst_leaf(port["change"], ref["change"], moving)}
