"""The port's multi-process training on two gloo processes, mirroring
``tests/test_multihost.py:69-158``: a TwinGAN round over the processes'
rows against the JAX package's round on a 2-device mesh (the test
process's virtual CPU devices), and the training command
(``pggan_runner.main``, one process each, as torchrun starts them) through
a progressive plan whose processes are both killed inside the growing
stage and restarted, resuming it and completing the plan.

One spawn of two processes (``tests/torch_parallel_worker.py``, torch and
the port only) runs the round (``tests/multihost_worker.py``'s
``build_round`` configuration: 8 px, max_channels 8, instance norm, UNet,
the gan loss, global batch 8, n_critic 2; ``bn_num_groups=2`` on both
sides) and then the plan (TwinGAN 4 -> 8 px, 4 images a process a step,
160 images a resolution: 20 steps a stage, a checkpoint every 2), until
both processes are killed (SIGKILL, each by itself) right after the
growing stage's checkpoint at step 2; a second spawn resumes. Only the first process may write under the train
dir. Tolerances are the JAX test's: the processes' metrics equal to rtol
1e-5, and within rtol 1e-4 / atol 1e-5 of the single-process round.
"""

import glob
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

import torch_parallel_worker as worker  # noqa: E402
from test_torch_parallel import _merge  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.parallel import create_mesh, replicate, shard_batch  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

WORLD = 2
ROUND_MODEL = dict(resolution=8, max_channels=8, norm_type="instance_norm", num_domains=2,
                   bn_num_groups=WORLD)
ROUND_SEED = 7
STEPS = 20


def plan_flags(train_dir: str) -> list:
    return [f"--train_dir={train_dir}", "--program_name=twingan", "--use_synthetic_data=true",
            "--start_hw=4", "--max_hw=8", "--batch_size=4",
            f"--num_images_per_resolution={STEPS * 8}",
            "--pggan_max_num_channels=8", "--learning_rate=0.001", "--log_every_n_steps=1",
            "--save_every_n_steps=2", "--log_image_every_n_iter=0", "--device=cpu",
            f"--num_devices={WORLD}"]


def round_inputs() -> dict:
    batches = [{"source": np.random.RandomState(2 * i).rand(8, 8, 8, 3).astype(np.float32),
                "target": np.random.RandomState(2 * i + 1).rand(8, 8, 8, 3).astype(np.float32)}
               for i in range(2)]
    return {"round_model": ROUND_MODEL, "round_batch": 8, "round_seed": ROUND_SEED,
            "round_batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]}


def jax_round(inputs: dict) -> dict:
    """The JAX round on a 2-device mesh from the port's initial state."""
    jtrainer = JaxTwinGANTrainer(JaxTwinGANConfig(
        model=JaxPGGANConfig(**ROUND_MODEL), loss=JaxGanLossConfig(architecture="gan"),
        opt=JaxOptimizerConfig(learning_rate=1e-3), batch_size=8, use_unet=True, max_steps=10))
    ptrainer = TwinGANTrainer(TwinGANConfig(
        model=PGGANConfig(**ROUND_MODEL), loss=GanLossConfig(architecture="gan"),
        opt=OptimizerConfig(learning_rate=1e-3), batch_size=8, use_unet=True, max_steps=10),
        device="cpu")
    template = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    tree = serialization.to_state_dict(template)
    _merge(tree, bridge.flax_state_dict(ptrainer.init_state(ROUND_SEED)))
    mesh = create_mesh(jax.devices()[:WORLD])
    state = replicate(jax.tree_util.tree_map(jnp.asarray,
                                             serialization.from_state_dict(template, tree)), mesh)
    batches = [shard_batch({k: v.numpy() for k, v in b.items()}, mesh)
               for b in inputs["round_batches"]]
    _, metrics = jtrainer.round_step(state, batches, jax.random.PRNGKey(1))
    return {k: float(v) for k, v in metrics.items()}


def _checkpointed(stage_dir: str) -> bool:
    return bool(glob.glob(os.path.join(stage_dir, "ckpt-*", "state.pt")))


def _tagged(text: str, tag: str):
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    assert lines, f"no {tag} line:\n{text}"
    return json.loads(lines[0][len(tag) + 1:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multihost")
    inputs = round_inputs()
    path = str(root / "inputs.pt")
    torch.save(inputs, path)
    train_dir = str(root / "train")
    first = str(root / "first")
    procs = worker.spawn("round_plan", path, first, plan_flags(train_dir), world=WORLD)
    try:
        jax_metrics = jax_round(inputs)
        for p in procs:
            p.wait(timeout=2 * worker.TIMEOUT_S)
    finally:
        worker.kill(procs)
    assert all(p.returncode == -signal.SIGKILL for p in procs), worker.output(first)
    outs = [open(os.path.join(first, f"rank{r}.out")).read() for r in range(WORLD)]
    killed_at = sorted(os.listdir(os.path.join(train_dir, worker.KILL_STAGE)))
    stage4_complete = _checkpointed(os.path.join(train_dir, "4"))
    second = str(root / "second")
    results = worker.collect(worker.spawn("plan", "-", second, plan_flags(train_dir),
                                          world=WORLD), second)
    return {"metrics": [_tagged(o, "METRICS") for o in outs], "jax": jax_metrics,
            "stage4_complete": stage4_complete, "killed_at": killed_at, "resumed": results,
            "train_dir": train_dir}


def test_two_process_round_matches_jax(runs):
    a, b = runs["metrics"]
    assert a["step"] == b["step"] == 1
    assert set(a) - {"step"} == set(runs["jax"])
    for k, v in runs["jax"].items():
        assert np.isfinite(a[k]), k
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(a[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{k}: two processes vs the JAX round")


def test_two_process_plan_resumes_after_a_kill(runs):
    assert runs["stage4_complete"], "stage 4 should have completed before the kill"
    # Killed inside the growing stage: its checkpoint at step 2, no model.
    assert f"ckpt-{worker.KILL_STEP}" in runs["killed_at"]
    assert "model.pt" not in runs["killed_at"], runs["killed_at"]
    summaries = [r["summary"] for r in runs["resumed"]]
    for r, s in zip(runs["resumed"], summaries):
        assert s["4"] == {"skipped": True, "step": STEPS}
        assert s["4to8"]["steps"] == STEPS and s["8"]["steps"] == STEPS
        assert s["4to8"]["started"]["resumed_at"] == worker.KILL_STEP, s["4to8"]
        assert "resumed at step" in r["stdout"], r["stdout"]
    assert summaries[0]["4to8"]["started"] == summaries[1]["4to8"]["started"]


def test_only_the_first_process_writes(runs):
    """The second process opened nothing for writing under the train dir
    and saved nothing there; the first wrote every stage's files."""
    assert _tagged(runs["resumed"][1]["stdout"], "WRITES") == []
    for stage in ("4", "4to8", "8"):
        for name in ("config.json", "model.pt", f"ckpt-{STEPS}/state.pt"):
            assert os.path.isfile(os.path.join(runs["train_dir"], stage, name)), (stage, name)
