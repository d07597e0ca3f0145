"""Stage-1 train-state checkpoints: save and resume a ``Stage1Trainer``.

Port of ``dreamgaussian_tpu/utils/checkpoint.py``, written as the port's
own npz file (no orbax, no pickle) in the checkpoint directory. The file
holds the complete state, so a resumed run continues bit for bit where
the device's arithmetic is deterministic (on the CPU):

- ``p_<name>``, ``mu_<name>``, ``nu_<name>``: params and Adam moments
  (zero-size arrays such as ``f_rest`` at sh_degree 0 included);
  ``adam_count``;
- ``aux_<field>``: the ``GaussianAux`` fields;
- ``step``, and ``densify_dropped``: the candidates a densify found no
  slot for that the trainer has not yet grown its capacity for;
- ``np_rng``: the camera sampler's ``bit_generator.state`` as JSON text;
- ``draw_state``: the state of the trainer's ``TorchDraw``.

The capacity is the params' row count: a trainer restored from a file
written after its capacity grew takes the saved capacity.

Mesh independence. A trainer on a (data, tile) mesh keeps its state
replicated: every rank holds the same parameters, Adam moments, densify
stats, step and random states (``train/stage1.py``). So the file is the
one a single process writes, in the same layout whatever the mesh, and a
checkpoint written on any mesh (one process, data2, tile2, data2xtile2)
resumes on any other. Rank 0 alone writes it. On a mesh rank 0 alone reads
it too, and every array of the state goes from rank 0 to the other ranks
over the default process group (gloo on the CPU or for ranks that share a
card, NCCL on cards), as raw bytes: the other ranks need no file, and
after the restore every rank's state is rank 0's bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

FILE = "stage1.npz"


def checkpoint_file(path: str) -> str:
    """The npz file inside the checkpoint directory ``path``."""
    return os.path.join(path, FILE)


def save_stage1(path: str, trainer) -> str:
    """Write ``trainer``'s state to ``<path>/stage1.npz`` (``path`` is a
    directory, made if missing); returns the file's path. The file is
    written beside its final name and renamed over it, so an interrupted
    save leaves the previous checkpoint whole."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    arrs = {f"p_{k}": host(v) for k, v in trainer.params.items()}
    arrs.update({f"mu_{k}": host(v) for k, v in trainer.adam.mu.items()})
    arrs.update({f"nu_{k}": host(v) for k, v in trainer.adam.nu.items()})
    arrs.update({f"aux_{k}": host(v) for k, v in trainer.aux._asdict().items()})
    arrs["adam_count"] = np.asarray(int(trainer.adam.count))
    arrs["step"] = np.asarray(trainer.step)
    dropped = trainer.densify_dropped
    arrs["densify_dropped"] = np.asarray(0 if dropped is None else int(dropped))
    arrs["np_rng"] = np.asarray(json.dumps(trainer.rng.bit_generator.state))
    get_state = getattr(trainer.draw, "get_state", None)
    if get_state is not None:
        arrs["draw_state"] = get_state()
    os.makedirs(path, exist_ok=True)
    final = checkpoint_file(path)
    tmp = final + ".partial"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return final


def _read(path: str) -> dict:
    """Every array of ``<path>/stage1.npz``."""
    with np.load(checkpoint_file(path), allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _broadcast(arrays: dict | None, device, error: str = "") -> dict:
    """Rank 0's ``arrays`` on every rank of the default group: a manifest
    (name, dtype, shape of each, as JSON) and one buffer of their bytes, each
    sent from rank 0 on ``device``. Rank 0 sends ``error`` in place of the
    arrays when it could not read them; then every rank raises."""
    import torch.distributed as dist

    root = dist.get_rank() == 0
    if root:
        head = ({"error": error} if arrays is None
                else [(k, v.dtype.str, v.shape) for k, v in arrays.items()])
        parts = [json.dumps(head).encode(),
                 b"".join(np.ascontiguousarray(v).tobytes() for v in (arrays or {}).values())]
    sizes = torch.tensor([len(p) for p in parts] if root else [0, 0], dtype=torch.int64,
                         device=device)
    dist.broadcast(sizes, 0)
    got = []
    for i, n in enumerate(sizes.tolist()):
        buf = (torch.frombuffer(bytearray(parts[i]), dtype=torch.uint8) if root and n
               else torch.empty(n, dtype=torch.uint8)).to(device)
        if n:
            dist.broadcast(buf, 0)
        got.append(buf.cpu().numpy().tobytes())
    head = json.loads(got[0])
    if isinstance(head, dict):
        raise RuntimeError(f"rank 0 could not read the checkpoint: {head['error']}")
    out, at = {}, 0
    for name, dtype, shape in head:
        dt = np.dtype(dtype)
        n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        out[name] = np.frombuffer(got[1][at:at + n], dtype=dt).reshape(shape).copy()
        at += n
    return out


def restore_stage1(path: str, trainer) -> None:
    """Restore ``trainer`` in place from ``<path>/stage1.npz``. On a mesh
    (``trainer.mesh`` with a process group) rank 0 reads the file and every
    rank takes rank 0's arrays (``_broadcast``): the other ranks read no
    file, and ``path`` need not exist there."""
    from ..scene.gaussians import GaussianAux
    from ..scene.optim import AdamState

    dev = trainer.device
    mesh = getattr(trainer, "mesh", None)
    if mesh is None or mesh.backend is None:
        data = _read(path)
    else:
        arrays, error = None, ""
        if mesh.rank == 0:
            try:
                arrays = _read(path)
            except (OSError, ValueError) as e:
                error = f"{checkpoint_file(path)}: {e}"
        data = _broadcast(arrays, dev, error)
    pick = lambda prefix: {k[len(prefix):]: torch.from_numpy(v).to(dev)  # noqa: E731
                           for k, v in data.items() if k.startswith(prefix)}
    trainer.params = pick("p_")
    trainer.adam = AdamState(mu=pick("mu_"), nu=pick("nu_"), count=int(data["adam_count"]))
    trainer.aux = GaussianAux(**pick("aux_"))
    trainer.step = int(data["step"])
    dropped = int(data["densify_dropped"])
    trainer.densify_dropped = torch.tensor(dropped, device=dev) if dropped else None
    trainer.rng.bit_generator.state = json.loads(str(data["np_rng"]))
    if "draw_state" in data:
        set_state = getattr(trainer.draw, "set_state", None)
        if set_state is None:
            raise ValueError(f"{checkpoint_file(path)} holds a draw state, but the "
                             "trainer's draw function takes none")
        set_state(data["draw_state"])
    trainer.capacity = int(trainer.params["xyz"].shape[0])
    trainer.overflow = None
