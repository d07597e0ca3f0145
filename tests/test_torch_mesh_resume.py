"""Stage-1 checkpoints across meshes: the port's gloo ranks on the CPU
(``tests/torch_shard_cases.py``) against the JAX package on the virtual CPU
devices.

- A data2 run saved at step STOP and resumed on data2 equals the unbroken
  data2 run bit for bit (the trainer's own seeded draws, densify active).
- Rank 1, given a checkpoint folder that does not exist, resumes at rank
  0's step with rank 0's state bit for bit (rank 0 reads the file and sends
  every array; cli.main's ``resume_checkpoint``).
- ``resume=True`` with no checkpoint on rank 0 starts every rank at step 0,
  though rank 1's folder holds one; a folder without the file on rank 0
  fails every rank.
- A data2 checkpoint resumed in one process, and a one-process checkpoint
  resumed on data2xtile2, each against the JAX package doing the same
  switch (its data2 mesh trainer saves and its one-device trainer
  restores, or the reverse), with JAX's draws injected as
  ``test_torch_parallel.py::test_mesh_trainer_matches_jax_mesh_trainer``
  injects them and at its bounds. As there, the port's data2xtile2 is held
  against JAX's data2 trainer: JAX's trainer on a mesh with a tile axis
  leaves its data-only and one-device trainers from the second step on (a
  fault of the reference, ``ROADMAP.md`` section 3), while tile sharding
  changes no step's arithmetic beyond the order of float32 sums.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dreamgaussian_tpu.train import Stage1Trainer as JTrainer
from dreamgaussian_tpu.utils.config import Config
from dreamgaussian_tpu_torch.scene import adam_init as t_adam_init
from dreamgaussian_tpu_torch.train import Stage1Trainer as TTrainer
from test_torch_parallel import _jax_guidance, _target, _trainer_opt
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import Injected, plain_guidance, run_ranks, write_inputs

# The mesh switch: STEPS train_steps in all, the checkpoint after STOP.
# Densify fires on steps 3 and 6, on each side of the switch; the opacity
# reset on step 5.
STEPS, STOP, CAP, SEED = 6, 3, 512, 0
# The resume runs on data2: ITERS steps, saved at RESUME_AT, densify active.
ITERS, RESUME_AT = 8, 4
RESUME_OPT = dict(iters=ITERS, ref_size=32, num_pts=256, sh_degree=0, batch_size=2,
                  novel_resolutions=[32] * 3, warmup_rgb_loss=True, density_start_iter=1,
                  density_end_iter=ITERS, densification_interval=3, opacity_reset_interval=5,
                  densify_grad_threshold=1e-4, elevation=0, radius=2.0, fovy=49.1,
                  final_prune=False)
TIMEOUT = 240


def _split_noise(key, legs):
    """The split noise of JAX's densify on each densify step, with the key
    that is left: ``legs`` is [(kind, first step, last step)], kind "mesh"
    (the mesh trainer's in-scan densify: two splits a step, the densify key
    split from the second's) or "one" (the one-device step: one split, and
    one more for a densify)."""
    noise = []
    for kind, first, last in legs:
        for s in range(first, last + 1):
            densify = s % 3 == 0
            if kind == "mesh":
                key, _ = jax.random.split(key)
                key, sub = jax.random.split(key)
                dkey = jax.random.split(sub, 1)[0]
            else:
                key, _ = jax.random.split(key)
                if densify:
                    key, dkey = jax.random.split(key)
            if densify:
                noise.append(np.asarray(jax.random.normal(dkey, (2, CAP, 3))))
    return noise, key


def _jax_switches(mesh, rgb, mask, work):
    """JAX's trainer on ``mesh`` and its one-device trainer, each STOP steps
    from the seed and saved; then each restores the other's checkpoint and
    runs to STEPS (two trainers, each compiled once). Returns the second
    legs of "a" (mesh -> one device) and "b" (one device -> mesh): losses,
    final state and the key left."""
    make = lambda m: JTrainer(Config(_trainer_opt()), ref_rgb=rgb, ref_mask=mask,  # noqa: E731
                              guidance_fns=((1.0, _jax_guidance),), capacity=CAP, seed=SEED, mesh=m)
    on_mesh, one = make(mesh), make(None)
    for trainer, path in ((on_mesh, work["jax_a"]), (one, work["jax_b"])):
        for _ in range(STOP):
            trainer.train_step()
        trainer.save_checkpoint(path)
    out = {}
    for name, trainer, path in (("a", one, work["jax_a"]), ("b", on_mesh, work["jax_b"])):
        trainer.load_checkpoint(path)
        losses = [float(trainer.train_step()) for _ in range(STEPS - STOP)]
        out[name] = {"losses": losses, "xyz": np.asarray(trainer.params["xyz"]),
                     "alive": np.asarray(trainer.aux.alive), "step": trainer.step,
                     "key": np.asarray(trainer.key)}
    return out


def _port_one_process(arrays, splits, steps, load=None, save=None):
    """The port's trainer in this process: from the given cloud or restored
    from ``load``, ``steps`` train_steps with the given split draws, then
    saved to ``save``; the losses and the final state."""
    tr = TTrainer(Config(_trainer_opt()), ref_rgb=arrays["ref_rgb"], ref_mask=arrays["ref_mask"],
                  guidance_fns=((1.0, plain_guidance),), capacity=CAP, seed=SEED, device="cpu",
                  draw=Injected({"split": splits}))
    if load:
        tr.load_checkpoint(load)
    else:
        tr.params = {k[2:]: torch.tensor(v) for k, v in arrays.items() if k.startswith("p_")}
        tr.aux = tr.aux._replace(**{k[4:]: torch.tensor(v) for k, v in arrays.items()
                                    if k.startswith("aux_")})
        tr.adam = t_adam_init(tr.params)
    losses = [float(tr.train_step()) for _ in range(steps)]
    if save:
        tr.save_checkpoint(save)
    return {"losses": losses, "xyz": tr.params["xyz"].numpy(), "alive": tr.aux.alive.numpy(),
            "step": tr.step}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file. The port's two ranks (the resume runs, then
    the first leg of data2 -> one process) and four ranks (the second leg of
    one process -> data2xtile2) run while this process computes the JAX
    switches and the port's one-process legs."""
    rgb, mask = _target()
    devices = np.array(jax.devices()[:2])
    data2 = Mesh(devices, ("data",))
    probe = JTrainer(Config(_trainer_opt()), ref_rgb=rgb, ref_mask=mask,
                     guidance_fns=((1.0, _jax_guidance),), capacity=CAP, seed=SEED)
    init_p, init_aux = jax.device_get(probe.params), jax.device_get(probe.aux)
    noise_a, key_a = _split_noise(probe.key, [("mesh", 1, STOP), ("one", STOP + 1, STEPS)])
    noise_b, key_b = _split_noise(probe.key, [("one", 1, STOP), ("mesh", STOP + 1, STEPS)])
    arrays = {**{f"p_{k}": np.asarray(v) for k, v in init_p.items()},
              **{f"aux_{k}": np.asarray(v) for k, v in init_aux._asdict().items()},
              "ref_rgb": rgb, "ref_mask": mask}
    work = {name: str(tmp_path_factory.mktemp(name)) for name in
            ("resume", "a_leg1", "b_leg2", "ckpt_a", "ckpt_b", "jax_a", "jax_b")}
    write_inputs(work["resume"], {"ref_rgb": _target(32)[0], "ref_mask": _target(32)[1]},
                 {"trainer": RESUME_OPT, "capacity": 1024, "seed": SEED, "iters": ITERS,
                  "stop": RESUME_AT})
    leg = {"trainer": _trainer_opt(), "capacity": CAP, "seed": SEED}
    write_inputs(work["a_leg1"], {**arrays, "split": np.stack(noise_a[:1])},
                 {**leg, "mesh": [2, 1], "steps": STOP, "save": work["ckpt_a"]})
    port_b1 = _port_one_process(arrays, noise_b[:1], STOP, save=work["ckpt_b"])
    write_inputs(work["b_leg2"], {**arrays, "split": np.stack(noise_b[1:])},
                 {**leg, "mesh": [2, 2], "steps": STEPS - STOP, "load": work["ckpt_b"]})
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(run_ranks, [("resume", work["resume"]),
                                         ("trainer_leg", work["a_leg1"])], 2, timeout=TIMEOUT)
        ranks4 = pool.submit(run_ranks, [("trainer_leg", work["b_leg2"])], 4, timeout=TIMEOUT)
        jax_legs = _jax_switches(data2, rgb, mask, work)
        resume, a_leg1 = ranks2.result()
        (b_leg2,) = ranks4.result()
    port_a2 = _port_one_process(arrays, noise_a[1:], STEPS - STOP, load=work["ckpt_a"])
    return {"resume": resume, "a": (a_leg1, port_a2, jax_legs["a"], key_a),
            "b": (port_b1, b_leg2, jax_legs["b"], key_b)}


def _same_state(got: dict, want: dict, prefix_got: str, prefix_want: str):
    keys = [k[len(prefix_want):] for k in want if k.startswith(prefix_want)]
    assert len(keys) >= 20
    for k in keys:
        np.testing.assert_array_equal(got[prefix_got + k], want[prefix_want + k], err_msg=k)


def test_data2_resume_equals_the_unbroken_data2_run(runs):
    """Saved at step RESUME_AT (after the densify of step 3), resumed, run to
    ITERS: every array, the step and both random states bit for bit, on
    every rank."""
    for rank in runs["resume"]:
        assert bool(rank["r_found"]) and int(rank["r_step"]) == RESUME_AT
        _same_state(rank, rank, "f_", "w_")
        assert int(rank["w_step"]) == ITERS


def test_rank_without_the_folder_resumes_from_rank_0(runs):
    """Rank 1 was given a folder that does not exist: it resumed at rank 0's
    step, with rank 0's state bit for bit."""
    rank0, rank1 = runs["resume"]
    _same_state(rank1, rank0, "r_", "r_")
    _same_state(rank1, rank0, "f_", "f_")


def test_no_checkpoint_on_rank_0_starts_every_rank_at_0(runs):
    """Rank 0's folder does not exist and rank 1's holds the checkpoint:
    rank 0 decides, and no rank resumes."""
    for rank in runs["resume"]:
        assert not bool(rank["d_found"]) and int(rank["d_step"]) == 0


def test_unreadable_checkpoint_on_rank_0_fails_every_rank(runs):
    """Rank 0's folder exists but holds no file: rank 0 sends the error in
    place of the state, and every rank raises it (none waits for arrays)."""
    for rank in runs["resume"]:
        assert "rank 0 could not read the checkpoint" in str(rank["e_error"]), rank["e_error"]
        assert "stage1.npz" in str(rank["e_error"])


@pytest.mark.parametrize("switch", ["a", "b"], ids=["data2_to_one_process",
                                                    "one_process_to_data2xtile2"])
def test_switched_mesh_matches_jax_doing_the_same_switch(runs, switch):
    """The second leg after the switch against JAX's: the losses and the
    positions at test_torch_parallel.py's bounds for the mesh trainer
    (losses 2e-4 relative, xyz 1e-5), the alive mask equal. JAX's key after
    its run equals the one the injected draws were taken along."""
    first, second, ref, key = runs[switch]
    legs = second if isinstance(second, list) else [second]
    np.testing.assert_array_equal(ref["key"], np.asarray(key))
    assert ref["step"] == STEPS
    for leg in legs:
        losses = leg["losses"] if "losses" in leg else [float(leg[f"loss_{i}"])
                                                        for i in range(STEPS - STOP)]
        np.testing.assert_allclose(losses, ref["losses"], rtol=2e-4)
        xyz = leg["xyz"] if "xyz" in leg else leg["p_xyz"]
        alive = leg["alive"] if "alive" in leg else leg["aux_alive"]
        np.testing.assert_allclose(xyz, ref["xyz"], atol=1e-5)
        np.testing.assert_array_equal(alive, ref["alive"])
    if isinstance(second, list):   # the ranks of data2xtile2: replicas bit for bit
        for r in second[1:]:
            for k in second[0]:
                np.testing.assert_array_equal(r[k], second[0][k], err_msg=k)
