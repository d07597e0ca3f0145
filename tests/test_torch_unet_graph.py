"""The UNet's forward replayed as a CUDA graph (``guidance/unet.py``).

On the CPU: which calls are graphed (``graphable``), what tells two
signatures apart (``signature``), the graph cache's captures, replays and
drops with a stand-in for the capture, and the counters of a plain CPU
call. On a card (marked ``cuda``, skipped without one): three small bf16
UNets shaped as Zero123, MVDream and ImageDream, whose graphed forward
must equal the eager body bit for bit. The file imports no JAX, so the
card tests run on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_unet_graph.py
"""

import pytest
import torch

from dreamgaussian_tpu_torch.guidance import unet as unet_mod
from dreamgaussian_tpu_torch.guidance.unet import UNet, UNetConfig, graphable, signature
from dreamgaussian_tpu_torch.utils import trace

TWO_LEVELS = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=64,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
CONFIGS = {
    # 8-channel input, conv projections in the transformers.
    "zero123": UNetConfig(in_channels=8, num_attention_heads=4, **TWO_LEVELS),
    # linear projections, joint attention over groups of 4 views, camera MLP.
    "mvdream": UNetConfig(in_channels=4, num_attention_heads=None, attention_head_dim=16,
                          use_linear_projection=True, num_views=4, **TWO_LEVELS),
    # groups of 4 + 1 identity views, the IP resampler's 4 image tokens.
    "imagedream": UNetConfig(in_channels=4, num_attention_heads=None, attention_head_dim=16,
                             use_linear_projection=True, num_views=5, ip_dim=4, ip_embed_dim=32,
                             ip_resampler_dim=64, ip_resampler_depth=1, ip_resampler_heads=2,
                             **TWO_LEVELS),
}
SIDE = 16           # latent side
TOKENS = 3          # context tokens


@pytest.fixture(autouse=True)
def tracing_left_off():
    """Every test starts and ends with tracing off and no records."""
    trace.disable()
    trace.records()
    yield
    trace.disable()
    trace.records()


def make_unet(kind: str, seed: int = 0) -> UNet:
    """The small UNet of ``kind`` with seeded weights (the resampler's
    latents, left empty by the constructor, drawn too)."""
    torch.manual_seed(seed)
    unet = UNet(CONFIGS[kind]).eval().requires_grad_(False)
    if kind == "imagedream":
        unet.image_embed.latents.normal_()
    return unet


def make_args(kind: str, groups: int, seed: int, device="cpu") -> tuple:
    """Fresh UNet arguments for ``groups`` groups of views: (sample,
    timesteps, context, camera, ip, ip_img), as the prior's guidance calls
    it (ImageDream with float timesteps)."""
    g = torch.Generator().manual_seed(seed)
    cfg = CONFIGS[kind]
    b = groups * cfg.num_views
    sample = torch.randn(b, SIDE, SIDE, cfg.in_channels, generator=g)
    context = torch.randn(b, TOKENS, cfg.cross_attention_dim, generator=g)
    camera = ip = ip_img = None
    if kind == "imagedream":
        timesteps = torch.randint(0, 1000, (b,), generator=g).float()
        ip = torch.randn(b, 5, cfg.ip_embed_dim, generator=g)
        ip_img = torch.randn(groups, SIDE, SIDE, 4, generator=g)
    else:
        timesteps = torch.randint(0, 1000, (b,), generator=g)
    if cfg.num_views > 1:
        camera = torch.randn(b, unet_mod.CAMERA_DIM, generator=g)
    return tuple(None if a is None else a.to(device) for a in
                 (sample, timesteps, context, camera, ip, ip_img))


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA device, for the
    eligibility rule."""

    @property
    def is_cuda(self):
        return True


def on_card(*shape):
    return torch.zeros(*shape).as_subclass(OnCard)


# -- CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("case, graphed", [
    ("every tensor on a card, no grad, no capture", True),
    ("the optional arguments None", True),
    ("CPU tensors", False),
    ("one CPU tensor among card tensors", False),
    ("grad enabled", False),
    ("inside a capture", False),
])
def test_graphable_only_on_a_card_without_grad_or_capture(monkeypatch, case, graphed):
    capturing = case == "inside a capture"
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    args = [on_card(2, 4, 4, 4), on_card(2), on_card(2, 1, 8), on_card(2, 16), None, None]
    if case == "the optional arguments None":
        args[3] = None
    if case == "CPU tensors":
        args = [torch.zeros(2, 4, 4, 4), torch.zeros(2), torch.zeros(2, 1, 8)] + [None] * 3
    if case == "one CPU tensor among card tensors":
        args[2] = torch.zeros(2, 1, 8)
    with torch.set_grad_enabled(case == "grad enabled"):
        assert graphable(tuple(args)) is graphed


def test_graphable_asks_no_capture_state_of_cpu_calls():
    """A CPU call is told apart by its tensors alone: a CPU-only build of
    PyTorch raises when asked whether a stream is capturing."""
    with torch.no_grad():
        assert not graphable((torch.zeros(1), torch.zeros(1), torch.zeros(1), None, None, None))


@pytest.mark.parametrize("position", [3, 4, 5])
def test_signature_tells_none_from_a_tensor(position):
    args = list(make_args("imagedream", 1, seed=0))
    without = list(args)
    without[position] = None
    assert signature(tuple(args)) != signature(tuple(without))
    assert signature(tuple(without))[0][position] is None


def test_signature_tells_the_timesteps_dtypes_apart():
    args = make_args("zero123", 2, seed=0)
    as_float = (args[0], args[1].float()) + args[2:]
    assert args[1].dtype == torch.int64
    assert signature(args) != signature(as_float)


def test_signature_is_shapes_and_dtypes_not_values():
    a, b = make_args("mvdream", 1, seed=0), make_args("mvdream", 1, seed=1)
    assert signature(a) == signature(b)
    assert signature(a) != signature(make_args("mvdream", 2, seed=0))
    assert signature(a) != signature(tuple(x.double() for x in a[:4]) + a[4:])


def test_cpu_call_is_eager_and_counts_one_call():
    unet = make_unet("zero123")
    args = make_args("zero123", 2, seed=0)
    trace.enable()
    with torch.no_grad():
        out = unet(*args)
        want = unet._forward(*args)
    rec = trace.records()
    assert rec["counters"] == {"unet.calls": 1}
    assert [s["name"] for s in rec["spans"]] == ["unet"]
    assert torch.equal(out, want)
    assert unet._graphs == {}


class StandIn:
    """The capture's stand-in on the CPU: runs the body eagerly on the
    arguments it is called with and counts its calls."""

    made = []

    def __init__(self, fn, args):
        self.fn, self.calls = fn, 0
        StandIn.made.append(self)

    def __call__(self, args):
        self.calls += 1
        return self.fn(*args)


@pytest.fixture
def stand_in(monkeypatch):
    """Every call graphable, ``CapturedForward`` replaced by ``StandIn``,
    and the drop's wait for the card's replays skipped."""
    StandIn.made = []
    monkeypatch.setattr(unet_mod, "graphable", lambda args: True)
    monkeypatch.setattr(unet_mod, "CapturedForward", StandIn)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return StandIn


def test_cache_captures_each_signature_once_and_replays_every_call(stand_in):
    unet = make_unet("mvdream")
    small, large = (make_args("mvdream", g, seed=g) for g in (1, 2))
    trace.enable()
    with torch.no_grad():
        for i in range(3):
            for args in (small, large):
                assert torch.equal(unet(*args), unet._forward(*args))
    assert trace.records()["counters"] == {"unet.calls": 6, "unet.graph_captures": 2,
                                           "unet.graph_replays": 6}
    assert [s.calls for s in stand_in.made] == [3, 3]
    assert set(unet._graphs) == {signature(small), signature(large)}


@pytest.mark.parametrize("change, recaptures", [
    ("weights copied in place", False),
    ("load_state_dict copying", True),
    ("load_state_dict(assign=True)", True),
    ("dtype cast", True),
    ("to() the same dtype", True),
])
def test_cache_dropped_when_the_weights_may_move(stand_in, change, recaptures):
    unet = make_unet("zero123")
    args = make_args("zero123", 1, seed=0)
    with torch.no_grad():
        unet(*args)
        state = {k: v.clone() * 0.5 for k, v in unet.state_dict().items()}
        if change == "weights copied in place":
            for p in unet.parameters():
                p.mul_(0.5)
        elif change == "load_state_dict copying":
            unet.load_state_dict(state)
        elif change == "load_state_dict(assign=True)":
            unet.load_state_dict(state, assign=True)
        elif change == "dtype cast":
            unet.double()
            args = tuple(a if a is None or not a.is_floating_point() else a.double()
                         for a in args)
        else:
            unet.to(torch.float32)
        assert (unet._graphs == {}) is recaptures
        trace.enable()
        out = unet(*args)
    assert trace.records()["counters"] == {"unet.calls": 1, "unet.graph_replays": 1,
                                           **({"unet.graph_captures": 1} if recaptures else {})}
    assert len(stand_in.made) == 1 + recaptures
    with torch.no_grad():
        assert torch.equal(out, unet._forward(*args))


def test_grad_enabled_call_leaves_the_cache_alone(monkeypatch):
    """The rule itself, not the stand-in's: with grad on the body runs
    eagerly and the output carries the graph of autograd."""
    monkeypatch.setattr(unet_mod, "CapturedForward", StandIn)
    StandIn.made = []
    unet = make_unet("zero123").requires_grad_(True)
    trace.enable()
    out = unet(*make_args("zero123", 1, seed=0))
    assert out.requires_grad
    assert trace.records()["counters"] == {"unet.calls": 1}
    assert StandIn.made == []


# -- the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def card_unet(kind: str, device) -> UNet:
    return make_unet(kind).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_graphed_forward_equals_the_eager_body(cuda_device, kind):
    """Three calls of each of two signatures, interleaved, fresh arguments
    each time: every output equals the eager body's bit for bit, and each
    returned tensor is left alone by the calls after it."""
    unet = card_unet(kind, cuda_device)
    trace.enable()
    kept = []
    with torch.no_grad():
        for i in range(3):
            for groups in (1, 2):
                args = make_args(kind, groups, seed=10 * i + groups, device=cuda_device)
                out = unet(*args)
                assert torch.equal(out, unet._forward(*args)), (kind, i, groups)
                assert out.dtype == torch.float32
                kept.append((out, out.clone()))
    torch.cuda.synchronize()
    for out, copy in kept:
        assert torch.equal(out, copy)
    counters = trace.records()["counters"]
    assert counters == {"unet.calls": 6, "unet.graph_captures": 2, "unet.graph_replays": 6}


@pytest.mark.cuda
def test_grad_enabled_call_on_the_card_runs_eagerly(cuda_device):
    unet = card_unet("zero123", cuda_device)
    args = make_args("zero123", 1, seed=0, device=cuda_device)
    with torch.no_grad():
        unet(*args)
    trace.enable()
    sample = args[0].clone().requires_grad_(True)
    out = unet(sample, *args[1:])
    out.float().square().sum().backward()
    assert sample.grad is not None and bool(torch.isfinite(sample.grad).all())
    assert trace.records()["counters"] == {"unet.calls": 1}
    with torch.no_grad():
        assert torch.equal(out.detach(), unet._forward(*args))


@pytest.mark.cuda
def test_call_inside_another_capture_runs_eagerly(cuda_device):
    """The UNet called while an outer graph is being captured is captured
    into it as eager launches; replaying the outer graph gives the eager
    body's output."""
    unet = card_unet("mvdream", cuda_device)
    args = make_args("mvdream", 1, seed=0, device=cuda_device)
    static = tuple(a.clone() if a is not None else None for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    trace.enable()
    with torch.no_grad(), torch.cuda.stream(side):
        unet._forward(*static)
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer, stream=side):
            out = unet(*static)
    torch.cuda.current_stream().wait_stream(side)
    assert trace.records()["counters"] == {"unet.calls": 1}
    assert unet._graphs == {}
    fresh = make_args("mvdream", 1, seed=1, device=cuda_device)
    for buf, a in zip(static, fresh):
        if a is not None:
            buf.copy_(a)
    outer.replay()
    with torch.no_grad():
        assert torch.equal(out, unet._forward(*fresh))


@pytest.mark.cuda
def test_replays_see_weights_copied_in_place_and_recapture_after_a_move(cuda_device):
    unet = card_unet("imagedream", cuda_device)
    args = make_args("imagedream", 1, seed=0, device=cuda_device)
    trace.enable()
    with torch.no_grad():
        unet(*args)
        unet(*args)
        for p in unet.parameters():
            p.mul_(0.75)
        assert torch.equal(unet(*args), unet._forward(*args))
        assert trace.records()["counters"] == {"unet.calls": 3, "unet.graph_captures": 1,
                                               "unet.graph_replays": 3}
        state = {k: v.clone() * 2 for k, v in unet.state_dict().items()}
        unet.load_state_dict(state, assign=True)
        assert torch.equal(unet(*args), unet._forward(*args))
        unet.float()
        assert torch.equal(unet(*args), unet._forward(*args))
    assert trace.records()["counters"] == {"unet.calls": 2, "unet.graph_captures": 2,
                                           "unet.graph_replays": 2}


@pytest.mark.cuda
def test_one_signature_per_card_of_the_guidance(cuda_device):
    """Zero123's CFG call repeated as the SDS and the DDIM loop make it
    (batch 2, int64 timesteps) is one signature."""
    unet = card_unet("zero123", cuda_device)
    trace.enable()
    with torch.no_grad():
        for seed in range(4):
            unet(*make_args("zero123", 2, seed=seed, device=cuda_device))
    assert len(unet._graphs) == 1
    assert trace.records()["counters"] == {"unet.calls": 4, "unet.graph_captures": 1,
                                           "unet.graph_replays": 4}

