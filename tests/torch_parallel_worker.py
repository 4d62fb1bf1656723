"""One process of the port's multi-process tests on the CPU — not a pytest
module. It imports torch and the port only; the JAX references are
computed by the test in its own process.

Usage: torch_parallel_worker.py <suite> <inputs.pt> <out_dir> [runner flags...]

The process group comes from torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which
the test's spawner sets, through ``parallel.initialize_from_env`` with
gloo on the CPU. Each process writes ``<out_dir>/rank<r>.pt`` with its
results.

suite "parallel" (``tests/test_torch_parallel.py``): context-parallel
attention in the generator and the discriminator (forward, and each
process's gradient of its rows' share of the loss), the local-path cases
(a group of one process, no group), synced moments, grouped and synced
batch norm with its moving statistics and renorm EMAs, cross-process
minibatch stddev, a data-parallel ``GanTrainer`` G step, the trainers'
own draws, and the runner's augmentation of each process's rows.

suite "round_plan" (``tests/test_torch_multihost.py``): one TwinGAN
round on each process's rows (its metrics printed as ``METRICS <json>``),
then the training command ``pggan_runner.main`` with the flags after the
out dir, every process killing itself (SIGKILL) once the growing stage
``KILL_STAGE``'s checkpoint at step ``KILL_STEP`` is written and the
barrier after it passed: a kill inside the stage at a step the test
knows. Suite "plan" runs the training command alone and prints ``WRITES
<json>``: the files a process other than the first wrote under the train
dir (none is expected).
"""

import builtins
import json
import os
import signal
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

TIMEOUT_S = 120.0
WORKER = os.path.abspath(__file__)
KILL_STAGE, KILL_STEP = "4to8", 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite: str, inputs_path: str, out_dir: str, flags=(), world: int = 2) -> list:
    """Start ``world`` processes of this script as torchrun would (one
    gloo group on a free localhost port, one thread each), their output
    in ``<out_dir>/rank<r>.out`` and ``.err``."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        with open(os.path.join(out_dir, f"rank{r}.out"), "w") as out, \
                open(os.path.join(out_dir, f"rank{r}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, suite, inputs_path, out_dir, *flags],
                env=env, stdout=out, stderr=err))
    return procs


def kill(procs: list) -> None:
    for p in procs:
        p.kill()
    for p in procs:
        p.wait()


def collect(procs: list, out_dir: str, timeout: float = 2 * TIMEOUT_S) -> list:
    """Each process's results and output once all have exited 0; any
    failure or a wait past ``timeout`` kills every process and raises."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill(procs)
        raise AssertionError(f"workers still running after {timeout} s:\n" + output(out_dir))
    if any(p.returncode for p in procs):
        kill(procs)
        raise AssertionError("a worker failed:\n" + output(out_dir))
    return [dict(torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True),
                 stdout=open(os.path.join(out_dir, f"rank{r}.out")).read())
            for r in range(len(procs))]


def output(out_dir: str) -> str:
    """Every process's output and errors, for a failure message."""
    text = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith((".out", ".err")):
            text.append(f"--- {name}\n" + open(os.path.join(out_dir, name)).read()[-4000:])
    return "\n".join(text)


def _grads(module: torch.nn.Module) -> dict:
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
            for k, p in module.named_parameters()}


def _rows(x: torch.Tensor) -> torch.Tensor:
    from twingan_tpu_torch import parallel

    return parallel.local_rows(x)


def parallel_suite(inputs: dict) -> dict:
    from twingan_tpu_torch import parallel
    from twingan_tpu_torch.models import dcgan, pggan
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.models.layers import DomainNorm
    from twingan_tpu_torch.ops import basic, norms
    from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
    from twingan_tpu_torch.train.losses import GanLossConfig
    from twingan_tpu_torch.train.optimizers import OptimizerConfig

    group = parallel.current_group()
    out: dict = {}

    # Context-parallel attention in the generator and the discriminator.
    for name, build, x in (("gen", lambda c: pggan.Generator(c), inputs["code"]),
                           ("dis", lambda c: pggan.Discriminator(c), inputs["images"])):
        net = build(PGGANConfig(**inputs["cp_model"]))
        net.load_state_dict(inputs[f"{name}_weights"])
        y = net(_rows(x))
        torch.sum(torch.square(y.float())).backward()
        out[f"{name}_cp"] = y.detach()
        out[f"{name}_cp_grads"] = _grads(net)

    # The local-path cases of the generator: a group of one process (each
    # process its own), and no group, against the layer without the flag.
    singles = [torch.distributed.new_group([r]) for r in range(parallel.world_size(group))]
    code = _rows(inputs["code"])
    with torch.no_grad():
        local = pggan.Generator(PGGANConfig(**dict(inputs["cp_model"],
                                                   attention_context_parallel=False)))
        local.load_state_dict(inputs["gen_weights"])
        cp = pggan.Generator(PGGANConfig(**inputs["cp_model"]))
        cp.load_state_dict(inputs["gen_weights"])
        out["gen_local"] = local(code)
        parallel.set_current_group(singles[parallel.rank(group)])
        out["gen_single"] = cp(code)
        parallel.set_current_group(None)
        out["gen_no_group"] = cp(code)
        parallel.set_current_group(group)

    # Synced moments (NHWC, over every axis but the channels).
    out["moments"] = torch.stack(norms.moments(_rows(inputs["moments_x"]), (0, 1, 2), group))

    # Batch norm on each process's rows: (kind, groups of the whole
    # batch, sync), normalized output and the bank's statistics after an
    # updating call.
    for key, (kind, groups, sync) in inputs["norm_cases"].items():
        norm = DomainNorm(kind, inputs["norm_x"].shape[-1], num_groups=groups, sync=sync)
        norm.load_state_dict(inputs["norm_weights"][kind])
        norm.train()
        xl = _rows(inputs["norm_x"])
        y = norm(xl.permute(0, 3, 1, 2), 0, update=True).permute(0, 2, 3, 1)
        out[f"norm_{key}"] = y.detach()
        out[f"norm_{key}_stats"] = {k: v.clone() for k, v in norm.state_dict().items()}

    # The alternative networks' stock batch norm (DCGAN's discriminator) in
    # train mode on each process's rows: the global batch's moments, the
    # running moments after an updating call, the gradient of a sum.
    dis = dcgan.DCGANDiscriminator(depth=4, input_size=inputs["dcgan_images"].shape[1])
    dis.load_state_dict(inputs["dcgan_weights"])
    dis.train()
    y = dis(_rows(inputs["dcgan_images"]), update=True)
    torch.sum(torch.square(y)).backward()
    out["dcgan_dis"] = y.detach()
    out["dcgan_dis_grads"] = _grads(dis)
    out["dcgan_dis_stats"] = {k: v.clone() for k, v in dis.named_buffers()}

    # Minibatch stddev: one group, and three sub-batches end to end as the
    # fused discriminator pass lays them out (each process its rows of
    # each); the gradient of a weighted sum.
    for key, groups in (("stddev", 1), ("stddev_fused", 3)):
        xs = torch.cat([_rows(t) for t in inputs["stddev_x"][:groups]]).requires_grad_(True)
        y = basic.minibatch_stddev(xs, num_groups=groups, group=group)
        weight = torch.cat([_rows(t) for t in inputs["stddev_w"][:groups]])
        (grad,) = torch.autograd.grad(torch.sum(y * weight), xs)
        out[key], out[f"{key}_grad"] = y.detach(), grad

    # A data-parallel GanTrainer G step, the JAX step's z injected whole.
    tcfg = GanTrainerConfig(model=PGGANConfig(**inputs["dp_model"]), batch_size=8,
                            opt=OptimizerConfig(learning_rate=1e-3),
                            loss=GanLossConfig(architecture="hinge"))
    trainer = GanTrainer(tcfg, device="cpu")
    state = trainer.init_state(inputs["dp_seed"])
    state, metrics = trainer.g_step(state, {"target": _rows(inputs["dp_images"])},
                                    z=inputs["dp_z"])
    out["dp_loss"] = metrics["generator_loss"]
    out["dp_params"] = {k: p.detach().clone()
                        for k, p in state.nets["generator"].named_parameters()}
    out["draws"] = drawn_steps(inputs)
    out["augment"] = augmented(inputs)
    return out


def augmented(inputs: dict) -> dict:
    """The runner's augmentation (crops, flips, the colour distortion) of
    this process's rows of ``aug_images``, as one batch ("1") and as two
    batches end to end ("2", a scan chunk's layout), with its rows of the
    draws made for all of them. Without a group, every row."""
    from twingan_tpu_torch import parallel
    from twingan_tpu_torch.data.preprocess import PreprocessConfig
    from twingan_tpu_torch.runner.stage_runner import augment_rows

    cfg = PreprocessConfig(output_hw=8, do_random_cropping=True, is_training=True,
                           fast_mode=False)
    images = inputs["aug_images"]
    return {str(parts): augment_rows(parallel.local_rows(images, parts), images.shape, cfg,
                                     torch.Generator().manual_seed(3), parts)
            for parts in (1, 2)}


def _record_grads(state) -> list:
    """Each optimizer step's gradients (after their all-reduce), in order."""
    seen: list = []
    for opt in (state.gen_opt, state.dis_opt):
        def step(grads, inner=opt.step):
            seen.append([g.detach().clone() for g in grads])
            inner(grads)
        opt.step = step
    return seen


def drawn_steps(inputs: dict) -> dict:
    """A G and a D step of each trainer with every draw made by the trainer
    (none injected): a ``GanTrainer`` (DRAGAN, gdrop at strength 0.3) and
    a fused ``TwinGANTrainer`` (instance norm, the style embedding, gdrop,
    DRAGAN), on this process's rows; each step's gradients and metrics.
    Without a group, on the whole batch, it is one process's reference."""
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
    from twingan_tpu_torch.train.losses import GanLossConfig
    from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer

    dragan = GanLossConfig(architecture="dragan")
    trainers = {
        "gan": GanTrainer(GanTrainerConfig(
            model=PGGANConfig(resolution=8, max_channels=16, norm_type="instance_norm"),
            batch_size=8, use_gdrop=True, loss=dragan), device="cpu"),
        "twingan": TwinGANTrainer(TwinGANConfig(
            model=PGGANConfig(resolution=8, max_channels=8, norm_type="instance_norm",
                              num_domains=2, style_dim=4),
            batch_size=8, use_style_embedding=True, style_embed_size=4, use_gdrop=True,
            loss=dragan), device="cpu"),
    }
    images = _rows(inputs["dp_images"])
    batch = {"gan": {"target": images},
             "twingan": {"source": images, "target": _rows(inputs["draw_targets"])}}
    out = {}
    for name, trainer in trainers.items():
        state = trainer.init_state(11)
        state.gdrop_strength = torch.tensor(0.3)
        grads = _record_grads(state)
        state, g_metrics = trainer.g_step(state, batch[name], rng=5)
        state, d_metrics = trainer.d_step(state, batch[name], rng=5)
        out[name] = {"grads": grads,
                     "metrics": {k: float(v) for k, v in {**g_metrics, **d_metrics}.items()}}
    return out


def round_suite(inputs: dict) -> dict:
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.train.losses import GanLossConfig
    from twingan_tpu_torch.train.optimizers import OptimizerConfig
    from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer

    cfg = TwinGANConfig(model=PGGANConfig(**inputs["round_model"]),
                        loss=GanLossConfig(architecture="gan"),
                        opt=OptimizerConfig(learning_rate=1e-3),
                        batch_size=inputs["round_batch"], use_unet=True, max_steps=10)
    trainer = TwinGANTrainer(cfg, device="cpu")
    state = trainer.init_state(inputs["round_seed"])
    batches = [{k: _rows(v) for k, v in b.items()} for b in inputs["round_batches"]]
    state, metrics = trainer.round_step(state, batches, rng=1)
    values = {k: float(v) for k, v in metrics.items()}
    values["step"] = state.step
    print("METRICS " + json.dumps(values), flush=True)
    return {"metrics": values}


def die_after_checkpoint(stage: str, step: int) -> None:
    """SIGKILL this process right after ``stage``'s checkpoint at ``step``
    (every process has passed the barrier that follows the write)."""
    from twingan_tpu_torch.runner.checkpoint import CheckpointManager

    save = CheckpointManager.save

    def save_then_die(self, at, state, keep=3):
        path = save(self, at, state, keep)
        if os.path.basename(self.train_dir) == stage and at == step:
            os.kill(os.getpid(), signal.SIGKILL)
        return path

    CheckpointManager.save = save_then_die


def record_writes(train_dir: str) -> list:
    """Record every file this process opens for writing, or torch.saves,
    under ``train_dir``."""
    root = os.path.abspath(train_dir)
    writes: list = []
    real_open, real_save = builtins.open, torch.save

    def under(path) -> bool:
        return isinstance(path, (str, os.PathLike)) and os.path.abspath(path).startswith(root)

    def open_(file, mode="r", *a, **kw):
        if under(file) and any(c in mode for c in "wax+"):
            writes.append(os.path.relpath(file, root))
        return real_open(file, mode, *a, **kw)

    def save(obj, f, *a, **kw):
        if under(f):
            writes.append(os.path.relpath(f, root))
        return real_save(obj, f, *a, **kw)

    builtins.open, torch.save = open_, save
    return writes


def main() -> None:
    suite, inputs_path, out_dir = sys.argv[1:4]
    flags = sys.argv[4:]
    torch.set_num_threads(1)
    if suite in ("plan", "round_plan"):
        # tensorboard's event writer runs without TensorFlow; importing it
        # takes many seconds.
        sys.modules["tensorflow"] = None
    from twingan_tpu_torch import parallel

    assert parallel.initialize_from_env("cpu", timeout_s=TIMEOUT_S)
    rank = parallel.rank(parallel.current_group())
    inputs = torch.load(inputs_path, weights_only=True) if inputs_path != "-" else {}
    result: dict = {}
    if suite == "parallel":
        result = parallel_suite(inputs)
    if suite == "round_plan":
        result = round_suite(inputs)
        die_after_checkpoint(KILL_STAGE, KILL_STEP)
    if suite in ("plan", "round_plan"):
        from twingan_tpu_torch.runner import pggan_runner

        train_dir = next(f.split("=", 1)[1] for f in flags if f.startswith("--train_dir="))
        writes = record_writes(train_dir) if rank else []
        result["summary"] = pggan_runner.main(flags)
        print("WRITES " + json.dumps(writes), flush=True)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
