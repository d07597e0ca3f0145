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


def restore_stage1(path: str, trainer) -> None:
    """Restore ``trainer`` in place from ``<path>/stage1.npz``."""
    from ..scene.gaussians import GaussianAux
    from ..scene.optim import AdamState

    dev = trainer.device
    with np.load(checkpoint_file(path), allow_pickle=False) as data:
        pick = lambda prefix: {k[len(prefix):]: torch.from_numpy(data[k]).to(dev)  # noqa: E731
                               for k in data.files if k.startswith(prefix)}
        trainer.params = pick("p_")
        trainer.adam = AdamState(mu=pick("mu_"), nu=pick("nu_"), count=int(data["adam_count"]))
        trainer.aux = GaussianAux(**pick("aux_"))
        trainer.step = int(data["step"])
        dropped = int(data["densify_dropped"])
        trainer.densify_dropped = torch.tensor(dropped, device=dev) if dropped else None
        trainer.rng.bit_generator.state = json.loads(str(data["np_rng"]))
        if "draw_state" in data.files:
            set_state = getattr(trainer.draw, "set_state", None)
            if set_state is None:
                raise ValueError(f"{checkpoint_file(path)} holds a draw state, but the "
                                 "trainer's draw function takes none")
            set_state(data["draw_state"])
    trainer.capacity = int(trainer.params["xyz"].shape[0])
    trainer.overflow = None
