"""Ranks across nodes: the backend every rank agrees on, each rank's card,
and ``cli.main`` under two ``torchrun`` launchers (``--nnodes 2``, a static
rendezvous on localhost) on the CPU, stopped and resumed, against one
launcher's unbroken run. Card UUIDs and counts are monkeypatched, so the
rule's tests run without a card."""

import os
import re
import sys
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dreamgaussian_tpu_torch.parallel import multihost
from dreamgaussian_tpu_torch.parallel.launch import free_port, run_nodes, torchrun_nodes
from dreamgaussian_tpu_torch.scene import load_ply
from torch_cli_cases import disc_png
from torch_shard_cases import REPO

# -- the backend rule --------------------------------------------------------


@pytest.mark.parametrize("cards, backend", [
    (["cpu", "cpu"], "gloo"),
    (["GPU-a", "GPU-a"], "gloo"),                     # two launchers on one card
    (["GPU-a", "GPU-b"], "nccl"),                     # a card each
    (["GPU-a", "GPU-b", "GPU-c", "GPU-a"], "gloo"),   # one card shared among four
    (["GPU-a", "cpu"], "gloo"),
])
def test_backend_rule(cards, backend):
    assert multihost.choose_backend(cards) == backend


@pytest.fixture
def fake_cards(monkeypatch):
    """torch.cuda as each thread's host sees it: ``host.cards`` cards whose
    UUIDs name the host and the index."""
    host = threading.local()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(
        uuid=f"GPU-{host.name}-{torch.device(dev).index}"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: host.cards)
    monkeypatch.setattr(multihost, "resolve_device", torch.device)
    return host


def test_card_identity_is_the_cards_uuid(fake_cards):
    fake_cards.name, fake_cards.cards = "h0", 2
    assert multihost.card_identity("cuda:1") == "GPU-h0-1"
    assert multihost.card_identity(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("local_rank, cards, index",
                         [(None, 4, 0), (3, 4, 3), (1, 1, 0), (5, 2, 1)])
def test_each_rank_runs_on_its_local_ranks_card(fake_cards, monkeypatch, local_rank, cards, index):
    """``cuda:{LOCAL_RANK % cards}`` of the rank's own node."""
    fake_cards.name, fake_cards.cards = "h0", cards
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert multihost.rank_device("cuda") == torch.device("cuda", index)
    assert multihost.rank_device("cpu") == torch.device("cpu")


# Each node: (host, cards on the host, ranks the node's launcher starts).
LAYOUTS = {
    "two_launchers_share_one_card": ([("h0", 1, 1), ("h0", 1, 1)], "gloo"),
    "one_card_per_node": ([("h0", 1, 1), ("h1", 1, 1)], "nccl"),
    "four_cards_and_one": ([("h0", 4, 4), ("h1", 1, 2)], "gloo"),
    "mixed_counts_own_cards": ([("h0", 4, 2), ("h1", 1, 1)], "nccl"),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_agrees_on_the_backend(fake_cards, layout):
    """Every rank of every node posts its card (LOCAL_RANK's, on its host)
    to one store and takes the same backend, whatever its host's count."""
    nodes, want = LAYOUTS[layout]
    ranks = [(host, cards, local) for host, cards, n in nodes for local in range(n)]
    store, got = dist.HashStore(), {}

    def rank_main(rank, host, cards, local):
        fake_cards.name, fake_cards.cards = host, cards
        got[rank] = multihost.agree_backend(store, rank, len(ranks),
                                            torch.device("cuda", local % cards))

    threads = [threading.Thread(target=rank_main, args=(r, *spec)) for r, spec in enumerate(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert got == {r: want for r in range(len(ranks))}


# -- cli.main on two nodes, stopped and resumed ------------------------------

# A 64^2 frame has two tile rows of 32 for the tile axis. No prior: the
# known view's loss without its warm-up and one novel size make the first
# leg's steps (iters=STOP) those of the unbroken run. Densify on steps 2
# and 4, on each side of the checkpoint.
STOP, ITERS, CAP = 2, 4, 1024
CLI_ARGS = ["--config", "configs/image.yaml", "mesh=data2xtile2", "batch_size=2", "device=cpu",
            "lambda_zero123=0", "warmup_rgb_loss=False", "ref_size=64",
            "novel_resolutions=[64,64,64]", "num_pts=256", f"capacity={CAP}",
            "density_start_iter=1", "densification_interval=2", "save_mesh=False",
            "final_prune=False"]
LAUNCH_TIMEOUT = 240


def _cli(*args) -> list:
    return ["-m", "dreamgaussian_tpu_torch.cli.main", *CLI_ARGS, *args]


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    """One launcher's unbroken run of ITERS steps on four ranks, and the same
    on two launchers of two ranks each: STOP steps saved to node 0's folder,
    then resumed with node 1 given a folder that does not exist. Returns the
    logs and the folders."""
    import concurrent.futures

    tmp = tmp_path_factory.mktemp("two_nodes")
    png = disc_png(tmp / "disc.png")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    one, two = tmp / "one", tmp / "two"
    ckpt = {0: str(two / "ckpt"), 1: str(tmp / "node1" / "ckpt")}

    def node(r, port, *args):
        return [*torchrun_nodes(2, r, 2, port), *_cli(f"input={png}", f"outdir={two}",
                                                      "save_path=run", *args)]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        whole = pool.submit(run_nodes, lambda _: [
            sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
            *_cli(f"input={png}", f"outdir={one}", "save_path=run", f"iters={ITERS}")],
            1, LAUNCH_TIMEOUT, env)
        port = free_port()
        leg1 = pool.submit(run_nodes, lambda r: node(
            r, port, f"iters={STOP}", f"checkpoint_dir={ckpt[r]}", f"checkpoint_every={STOP}"),
            2, LAUNCH_TIMEOUT, env)
        whole, leg1 = whole.result(), leg1.result()
    port = free_port()
    leg2 = run_nodes(lambda r: node(r, port, f"iters={ITERS}", f"checkpoint_dir={ckpt[r]}",
                                    "resume=True"), 2, LAUNCH_TIMEOUT, env)
    return {"whole": whole[0], "leg1": leg1, "leg2": leg2, "one": one, "two": two, "ckpt": ckpt}


def test_two_nodes_train_on_gloo_with_each_tile_group_on_one_node(two_nodes):
    """Every rank reads its node (GROUP_RANK) and local rank as torchrun
    sets them; ranks 0-1 are node 0's and form one tile group, ranks 2-3
    node 1's and the other; the four CPU ranks agree on gloo."""
    log = "".join(two_nodes["leg2"])
    assert "[INFO] training on a data=2xtile=2 device mesh" in log and "backend gloo" in log, log
    for node, out in enumerate(two_nodes["leg2"]):
        for local in range(2):
            rank = 2 * node + local
            group = [2 * node, 2 * node + 1]
            assert (f"[shard] rank {rank}: node {node}, local rank {local}, device cpu, "
                    f"tile group {group}") in out, out


def test_leg_two_resumes_every_rank_at_the_first_legs_step(two_nodes):
    """Node 0 saved at step STOP; node 1's folder does not exist, and its
    ranks resume from rank 0's state all the same."""
    assert os.path.exists(os.path.join(two_nodes["ckpt"][0], "stage1.npz"))
    assert not os.path.exists(two_nodes["ckpt"][1])
    log = "".join(two_nodes["leg2"])
    resumed = sorted(int(r) for r in re.findall(
        rf"\[INFO\] resumed from \S+ at step {STOP} \(rank (\d)\)", log))
    assert resumed == [0, 1, 2, 3], log


def test_two_nodes_resumed_equal_one_launchers_unbroken_run(two_nodes):
    """The PLY (rank 0's) of the two legs on two nodes against the one
    launcher's unbroken run: bit for bit (the same ranks in the same gloo
    groups sum in the same order, and the resume is exact)."""
    a = load_ply(str(two_nodes["one"] / "run_model.ply"), capacity=CAP, device="cpu")
    b = load_ply(str(two_nodes["two"] / "run_model.ply"), capacity=CAP, device="cpu")
    assert int(a[1].alive.sum()) > 0
    np.testing.assert_array_equal(a[1].alive.numpy(), b[1].alive.numpy())
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k].numpy(), b[0][k].numpy(), err_msg=k)
