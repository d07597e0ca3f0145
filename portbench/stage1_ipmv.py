"""Runner of the ImageDream stage-1 cells (traffic kind ``stage1_ipmv``).

ImageDream's cells run ``stage1.py``'s steps, window and comparison; this
runner overrides only what depends on the prior:

- each sampled camera is a group of 4 views (``ctx["views"]``, the
  stretch's camera replay, the reference);
- the networks are ``reference/imagedream.py``'s, whose Resampler has
  ImageDream's head width, and the seeded weights follow their shapes
  (``guidance_weights``);
- the guidance is the port's ``ImageDreamGuidance`` on the seeded weights,
  the text states and the image states (``image_states``: the reference
  image's CLIP ViT-H/14 tokens and its latent ``ip_img``, N(0, 1) from the
  seed); the reference image itself goes to ``Stage1Trainer`` as
  ``cli/main.py`` passes it, and the trainer keeps no known view for
  ImageDream;
- the reference's SDS is ``reference/imagedream.py``;
- a step's model operations (``step_flops``) count the UNet call of batch
  2 x 5 per group, with the camera, the image tokens and ``ip_img``.

In the traced stretch the port's own tracing (``utils/trace.py``) is on:
``profile_stretch`` sums the device time of the kernels launched inside
the port's ``unet`` and ``imagedream.views`` spans beside the benchmark's
guidance span, and the port's counters and the host time of its spans
over the stretch go into ``ctx`` (``port_counters``,
``port_span_host_s``). The port's tracing is off everywhere else, the
window included.

``Run``, ``compare`` and ``leaf_gaps`` are what ``calibrate.py`` calls on
a runner module.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np
import torch

from . import inputs, work
from .reference import imagedream as ref_imagedream
from .reference import precision, render
from .reference.stage1 import ADAM_B1, LEAVES, Stage1, rung
from .stage1 import (COMPARED_STEPS, GUIDANCE_SPAN, STEP_SPAN, Cameras, Spanned, _sync,
                     _write_ply, compare, leaf_gaps)
from .stage1 import Run as Stage1Run

__all__ = ["Run", "compare", "leaf_gaps", "guidance_weights", "image_states", "step_flops"]

VIEWS = ref_imagedream.VIEWS
# The port's spans whose kernels' device time the traced stretch sums.
PORT_SPANS = ("unet", "imagedream.views")


def guidance_weights(arch: dict, seed: int, device) -> dict:
    """``inputs.guidance_weights``'s rule over ``reference/imagedream.py``'s
    networks: {"unet": state dict, "vae": state dict} of bfloat16 tensors on
    ``device``, views into one buffer drawn from the seed's weights stream;
    N(0, 1/fan_in), biases 0, norm scales 1."""
    specs = [(net, name, tuple(p.shape))
             for net, mod in zip(("unet", "vae"), ref_imagedream.nets(arch))
             for name, p in mod.named_parameters()]
    gen = torch.Generator(device=device).manual_seed(inputs.stream_seed(seed, "weights"))
    flat = torch.empty(sum(math.prod(s) for _, _, s in specs), dtype=torch.bfloat16,
                       device=device)
    flat.normal_(generator=gen)
    out, at = {"unet": {}, "vae": {}}, 0
    with torch.no_grad():
        for net, name, shape in specs:
            w = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            if name.endswith("bias"):
                w.zero_()
            elif len(shape) == 1:
                w.fill_(1.0)
            else:
                w.mul_(math.prod(shape[1:]) ** -0.5)
            out[net][name] = w
    return out


def image_states(arch: dict, seed: int, device) -> dict:
    """ImageDream's states (float32 on ``device``): ``inputs.states``'s
    text states, and the reference image's CLIP tokens [clip_tokens,
    ip_embed_dim] and latent ``ip_img`` [side / 8, side / 8, 4], N(0, 1)
    each (LayerNorm-scale tokens; a scaled latent), from a stream split
    off the seed's states stream."""
    out = inputs.states("imagedream", arch, seed, device)
    child = np.random.SeedSequence(inputs.stream_seed(seed, "states")).spawn(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(child.generate_state(1, np.uint64)[0]
                                                         >> np.uint64(1)))
    side = arch["image_size"] // 8
    out["clip_tokens"] = torch.randn((arch["clip_tokens"], arch["unet"]["ip_embed_dim"]),
                                     generator=gen, device=device)
    out["ip_img"] = torch.randn((side, side, 4), generator=gen, device=device)
    return out


def build_guidance(config: dict, seed: int, device):
    """The port's ``ImageDreamGuidance`` on the run's weights and states."""
    from dreamgaussian_tpu_torch.guidance.sds import ImageDreamGuidance
    from dreamgaussian_tpu_torch.guidance.unet import UNet, UNetConfig
    from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    arch = config["arch"]
    weights = guidance_weights(arch, seed, device)
    dtype = getattr(torch, config["precision"]["guidance_networks"])
    with torch.device("meta"):
        unet = UNet(UNetConfig(**arch["unet"])).to(dtype)
        vae = AutoencoderKL(VAEConfig(**arch["vae"])).to(dtype)
    unet.load_state_dict({k: v.to(dtype) for k, v in weights["unet"].items()}, assign=True)
    vae.load_state_dict({k: v.to(dtype) for k, v in weights["vae"].items()}, assign=True)
    unet.eval().requires_grad_(False)
    vae.eval().requires_grad_(False)
    st = image_states(arch, seed, device)
    return ImageDreamGuidance(unet, vae, {"pos": st["text_pos"], "neg": st["text_neg"]},
                              {"pos": st["clip_tokens"], "ip_img": st["ip_img"]},
                              image_size=arch["image_size"])


def step_flops(arch: dict, views: int) -> int:
    """A step's model operations: the UNet call on both CFG halves of the
    groups with their identity views, with the camera, the image tokens
    and ``ip_img``; the VAE encoder forward and its backward to the
    images of the rendered views."""
    unet, _ = ref_imagedream.nets(arch)
    unet.requires_grad_(False)
    groups = views // VIEWS
    n = 2 * groups * (VIEWS + 1)
    side = arch["image_size"] // 8
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    with torch.no_grad():
        call = work._count(lambda: unet(
            meta(n, side, side, arch["unet"]["in_channels"]), meta(n),
            meta(n, arch["context_tokens"], arch["unet"]["cross_attention_dim"]),
            camera=meta(n, 16), ip=meta(n, arch["clip_tokens"], arch["unet"]["ip_embed_dim"]),
            ip_img=meta(2 * groups, side, side, arch["unet"]["in_channels"])))
    # work.vae_flops builds reference/unet.py's UNet beside the VAE, and
    # that UNet takes no Resampler head width.
    plain = dict(arch, unet={k: v for k, v in arch["unet"].items()
                             if k != "ip_resampler_dim_head"})
    size = arch["image_size"]
    return (call + work.vae_flops(plain, views, size, "encode")
            + work.vae_flops(plain, views, size, "backward"))


class Run(Stage1Run):
    """``stage1.Run`` with ImageDream's views, guidance, reference and
    work count."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool,
                 rank: int = 0, port: int | None = None):
        super().__init__(config, traffic, seed, device, trace, rank, port)
        self.ctx["views"] = traffic["batch_size"] * VIEWS

    def setup(self) -> None:
        from dreamgaussian_tpu_torch.train import Stage1Trainer

        cfg, opt, dev = self.config, self.opt, self.device
        if self.world > 1:
            self.join()
        self.draws = inputs.Draws(self.seed, dev)
        self.guidance = build_guidance(cfg, self.seed, dev)
        fn = Spanned(self.guidance.guidance_fn()) if self.trace else self.guidance.guidance_fn()
        self.spanned = fn if self.trace else None
        capacity = opt["capacity"]
        rgb, mask = inputs.reference_view(self.seed, opt["ref_size"])
        folder = tempfile.mkdtemp(prefix="portbench-")
        ply = os.path.join(folder, "start.ply")
        try:
            _write_ply(ply, inputs.cloud(self.seed, capacity))
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

    def stretch(self) -> None:
        from torch.profiler import record_function

        from dreamgaussian_tpu_torch.utils import trace as port_trace

        from . import trace

        if not self.trace:
            super().stretch()
            return
        tr, opt, dev = self.trainer, self.opt, self.device
        n = self.traffic["trace_steps"]
        cams = Cameras(self.trainer_seed, opt, self.traffic["batch_size"], VIEWS)
        cams.skip(self.steps_done)
        per = self.ctx["views"] // self.world
        renders = []

        def step(i):
            size = rung(opt, self.traffic["start_step"] + self.steps_done + i)
            snap = ({k: v.detach().clone() for k, v in tr.params.items()}, tr.aux.alive.clone())
            _, _, poses, _ = cams.next()
            poses = poses[self.rank * per:(self.rank + 1) * per]
            renders.extend((snap, p, size) for p in poses)
            with record_function(STEP_SPAN):
                tr.train_step()

        self.spanned.on = True
        port_trace.enable()
        try:
            summary = trace.profile_stretch(step, n, spans=(GUIDANCE_SPAN,) + PORT_SPANS)
        finally:
            port_trace.disable()
            self.spanned.on = False
        rec = port_trace.records()
        self.steps_done += n
        host_s: dict = {}
        for s in rec["spans"]:
            host_s[s["name"]] = host_s.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) * 1e-9
        self.ctx.update(port_counters=rec["counters"], port_span_host_s=host_s)
        print(f"portbench: the port's counters over the traced stretch: {rec['counters']}",
              file=sys.stderr)
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
        self.ctx["flops_per_step"] = step_flops(self.config["arch"], self.ctx["views"])

    def reference(self, control: bool = False) -> dict:
        """The reference's compared steps from the run's inputs, with
        ImageDream's SDS; ``control`` runs its networks in fp8."""
        cfg, opt, dev = self.config, self.opt, self.device
        arch = cfg["arch"]
        prev_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            unet, vae = ref_imagedream.nets(arch)
            weights = guidance_weights(arch, self.seed, dev)
            unet.load_state_dict({k: v.float() for k, v in weights["unet"].items()}, assign=True)
            vae.load_state_dict({k: v.float() for k, v in weights["vae"].items()}, assign=True)
            del weights
            unet.eval().requires_grad_(False)
            vae.eval().requires_grad_(False)
            if control:
                precision.fp8_control(unet)
                precision.fp8_control(vae)
            sds = ref_imagedream.SDS(unet, vae, image_states(arch, self.seed, dev),
                                     arch["image_size"])
            capacity = opt["capacity"]
            p0 = {k: torch.from_numpy(v).to(dev)
                  for k, v in inputs.cloud(self.seed, capacity).items()}
            ref = Stage1(opt, p0, torch.ones(capacity, dtype=torch.bool, device=dev), None, None,
                         sds, cfg["guidance_weight"], np.random.default_rng(self.trainer_seed),
                         iter(self.draws.record), self.traffic["start_step"] - 1, VIEWS,
                         self.traffic["batch_size"], ranks=self.world)
            losses = []
            for i in range(COMPARED_STEPS):
                losses.append(ref.train_step())
                if i == 0:
                    g1 = {k: v / (1.0 - ADAM_B1) for k, v in ref.mu.items()}
            return {"loss": losses, "grad": g1,
                    "change": {k: ref.params[k] - p0[k] for k in LEAVES}}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32
