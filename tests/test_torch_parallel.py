"""The port's data parallelism on two gloo processes against the JAX
package's global view on a 2-device mesh (the test process's virtual CPU
devices): context-parallel attention in the generator and the
discriminator (``tests/test_parallel.py:101-228``'s generator: 16 px,
max_channels 16, instance norm, attention at 8 px, batch 8, every
sa_gamma 1 so that attention shows), the local-path cases, synced moments
(``tests/test_ops.py:132-150``'s shape), grouped and synced batch norm
with its moving statistics and renorm EMAs, the alternative networks'
batch norm (a DCGAN discriminator, 8 px, depth 4) on the global batch,
cross-process minibatch stddev, and a data-parallel ``GanTrainer`` G step
(``test_sharded_equals_single_device``'s configuration, its z injected).

The two processes (``tests/torch_parallel_worker.py``, torch and the port
only) are spawned once for the module and run every case; the JAX
references are computed here meanwhile. Each process returns its rows and
its gradient of its rows' share of a loss; the gradients of the whole
batch are their sum.

Tolerances: the context-parallel forwards rtol 1e-5 / atol 1e-6 against
the port's own layers without the split in one process, as the JAX
package's CP test holds its split to its local path, and rtol 1e-5 /
atol 1e-5 against JAX's split: without any split the port's generator
and the JAX one already differ by up to 5.0e-6 on these inputs (fp32
convs summed in another order), so 1e-6 cannot hold across the packages.
Gradients rtol 1e-2 / atol 2e-3 of the largest gradient, the JAX test's
stated tolerance for the all-gather's transposed sum, and against the
port's own path each leaf to rtol 1e-3 / atol 1e-3 of its own largest
entry (plus 1e-6 of the largest gradient); moments 1e-5; the
G step as ``test_sharded_equals_single_device``: loss rtol 1e-4,
parameters atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

import torch_parallel_worker as worker  # noqa: E402
from twingan_tpu import ops as jops  # noqa: E402
from twingan_tpu.models import dcgan as jdcgan  # noqa: E402
from twingan_tpu.models import layers as jlayers  # noqa: E402
from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.parallel import create_mesh, current_mesh, replicate  # noqa: E402
from twingan_tpu.parallel import set_current_mesh, shard_batch  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402

from twingan_tpu_torch import bridge, parallel  # noqa: E402
from twingan_tpu_torch.models import dcgan, pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.models.layers import DomainNorm, SelfAttention  # noqa: E402
from twingan_tpu_torch.models.layers import reset_parameters  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402

WORLD = 2
FWD = dict(rtol=1e-5, atol=1e-6)
CP_MODEL = dict(resolution=16, max_channels=16, norm_type="instance_norm",
                do_self_attention=True, self_attention_hw=8, attention_context_parallel=True)
DP_MODEL = dict(resolution=8, max_channels=16, norm_type="instance_norm")
DP_SEED = 3
# (kind, groups of the whole batch, sync) -> the JAX norm's groups.
NORM_CASES = {"bn_grouped": ("batch_norm", 2, False), "renorm_grouped": ("batch_renorm", 2, False),
              "bn_synced": ("batch_norm", 1, True), "renorm_synced": ("batch_renorm", 1, True),
              "bn_global": ("batch_norm", 1, False)}


def _weights(net: torch.nn.Module, seed: int) -> dict:
    reset_parameters(net, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, SelfAttention):
                m.sa_gamma.fill_(1.0)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _norm_weights(kind: str, channels: int, seed: int) -> dict:
    """A bank with every parameter and statistic drawn (renorm weights in
    (0.5, 1), as after some updates)."""
    norm = DomainNorm(kind, channels)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in norm.state_dict().items():
            if name.startswith(("gamma", "moving_var", "renorm_stddev_0")):
                t.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith("_weight_0"):
                t.uniform_(0.5, 1.0, generator=gen)
            else:
                t.normal_(0.0, 0.3, generator=gen)
    return {k: v.clone() for k, v in norm.state_dict().items()}


def make_inputs() -> dict:
    rs = np.random.RandomState(0)
    t = lambda *shape: torch.from_numpy(rs.rand(*shape).astype(np.float32))  # noqa: E731
    cfg = PGGANConfig(**CP_MODEL)
    return {
        "cp_model": CP_MODEL, "dp_model": DP_MODEL, "dp_seed": DP_SEED,
        "code": t(8, 4, 4, 16), "images": t(8, 16, 16, 3),
        "gen_weights": _weights(pggan.Generator(cfg), 0),
        "dis_weights": _weights(pggan.Discriminator(cfg), 1),
        "moments_x": torch.from_numpy(np.random.RandomState(3).randn(16, 4, 4, 3)
                                      .astype(np.float32)),
        "norm_x": torch.from_numpy(rs.randn(8, 4, 4, 6).astype(np.float32)),
        "norm_cases": NORM_CASES,
        "norm_weights": {k: _norm_weights(k, 6, 5) for k in ("batch_norm", "batch_renorm")},
        "stddev_x": [t(8, 4, 4, 5) for _ in range(3)],
        "stddev_w": [t(8, 4, 4, 6) for _ in range(3)],
        "dp_images": t(8, 8, 8, 3), "draw_targets": t(8, 8, 8, 3),
        "dp_z": torch.from_numpy(rs.randn(8, 1, 1, 16).astype(np.float32)),
        "aug_images": torch.from_numpy(np.random.RandomState(5).randint(
            0, 256, (8, 10, 10, 3)).astype(np.uint8)),
        "dcgan_images": t(8, 8, 8, 3), "dcgan_weights": _dcgan_weights(7),
    }


def _dcgan_weights(seed: int) -> dict:
    """A DCGAN discriminator (depth 4, 8 px) with every parameter and
    running moment drawn."""
    net = dcgan.DCGANDiscriminator(depth=4, input_size=8)
    reset_parameters(net, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("scale", "var")):
                t.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith(("bias", "mean")):
                t.normal_(0.0, 0.3, generator=gen)
    return {k: v.clone() for k, v in net.state_dict().items()}


def _on_mesh(fn):
    prev = current_mesh()
    set_current_mesh(create_mesh(jax.devices()[:WORLD]))
    try:
        return fn()
    finally:
        set_current_mesh(prev)


def _jax_grads_as_port(grads) -> dict:
    return {k: v.numpy() for k, v in bridge.state_dict_from_flax(jax.device_get(grads)).items()}


def _merge(tree: dict, update: dict) -> None:
    """``update``'s leaves written into the nested dict ``tree``."""
    for k, v in update.items():
        if isinstance(v, dict):
            _merge(tree[k], v)
        else:
            tree[k] = v


def jax_references(inputs: dict) -> dict:
    ref = {}
    jcfg = JaxPGGANConfig(**CP_MODEL)
    for name, module, x in (("gen", jpggan.Generator(jcfg), inputs["code"]),
                            ("dis", jpggan.Discriminator(jcfg), inputs["images"])):
        variables = bridge.flax_variables(inputs[f"{name}_weights"])
        x = jnp.asarray(x.numpy())

        def loss(params, module=module, x=x, variables=variables):
            y, _ = module.apply(dict(variables, params=params), x)
            return jnp.sum(jnp.square(y.astype(jnp.float32))), y

        (_, y), grads = _on_mesh(lambda loss=loss, variables=variables: jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"]))
        ref[f"{name}_cp"] = np.asarray(y)
        ref[f"{name}_cp_grads"] = _jax_grads_as_port(grads)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = create_mesh(jax.devices()[:WORLD])
    m, v = jax.jit(shard_map(lambda xs: jops.moments(xs, (0, 1, 2), axis_name="data"),
                             mesh=mesh, in_specs=P("data"), out_specs=(P(), P())))(
        inputs["moments_x"].numpy())
    ref["moments"] = np.stack([np.asarray(m), np.asarray(v)])

    x = jnp.asarray(inputs["norm_x"].numpy())
    for key, (kind, groups, _) in NORM_CASES.items():
        norm = jlayers.DomainNorm(kind=kind, num_groups=groups)
        variables = bridge.flax_variables(inputs["norm_weights"][kind])
        y, new = jax.jit(lambda v, x, norm=norm: norm.apply(
            v, x, jlayers.NormCtx(train=True), mutable=["batch_stats"]))(variables, x)
        ref[f"norm_{key}"] = np.asarray(y)
        ref[f"norm_{key}_stats"] = {k: v.numpy() for k, v in bridge.state_dict_from_flax(
            variables["params"], new["batch_stats"]).items()}

    for key, groups in (("stddev", 1), ("stddev_fused", 3)):
        xs = jnp.concatenate([jnp.asarray(a.numpy()) for a in inputs["stddev_x"][:groups]])
        w = jnp.concatenate([jnp.asarray(a.numpy()) for a in inputs["stddev_w"][:groups]])
        y = jax.jit(lambda a, groups=groups: jops.minibatch_stddev(a, num_groups=groups))(xs)
        grad = jax.jit(jax.grad(lambda a, w=w, groups=groups: jnp.sum(
            jops.minibatch_stddev(a, num_groups=groups) * w)))(xs)
        ref[key], ref[f"{key}_grad"] = np.asarray(y), np.asarray(grad)

    variables = bridge.flax_variables(inputs["dcgan_weights"])
    jdis = jdcgan.DCGANDiscriminator(depth=4)

    def dcgan_loss(params, x):
        (y, _), new = jdis.apply(dict(variables, params=params), x, train=True,
                                 mutable=["batch_stats"])
        return jnp.sum(jnp.square(y)), (y, new)

    grads, (y, new) = jax.jit(jax.grad(dcgan_loss, has_aux=True))(
        variables["params"], jnp.asarray(inputs["dcgan_images"].numpy()))
    ref["dcgan_dis"] = np.asarray(y)
    ref["dcgan_dis_grads"] = _jax_grads_as_port(grads)
    ref["dcgan_dis_stats"] = {k: v.numpy() for k, v in bridge.state_dict_from_flax(
        {}, jax.device_get(new["batch_stats"])).items()}

    jtrainer = JaxGanTrainer(JaxGanTrainerConfig(
        model=JaxPGGANConfig(**DP_MODEL), batch_size=8, opt=JaxOptimizerConfig(learning_rate=1e-3),
        loss=JaxGanLossConfig(architecture="hinge")))
    ptrainer = GanTrainer(GanTrainerConfig(
        model=PGGANConfig(**DP_MODEL), batch_size=8, opt=OptimizerConfig(learning_rate=1e-3),
        loss=GanLossConfig(architecture="hinge")), device="cpu")
    # The port's state in the JAX state's structure (eval_shape: no init).
    template = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    tree = serialization.to_state_dict(template)
    _merge(tree, bridge.flax_state_dict(ptrainer.init_state(DP_SEED)))
    state = serialization.from_state_dict(template, tree)
    state = replicate(jax.tree_util.tree_map(jnp.asarray, state), mesh)
    batch = shard_batch({"target": inputs["dp_images"].numpy(), "source": inputs["dp_z"].numpy()},
                        mesh)
    state, metrics = jtrainer.g_step(state, batch, jax.random.PRNGKey(1))
    ref["dp_loss"] = float(metrics["generator_loss"])
    ref["dp_params"] = {k: v.numpy() for k, v in bridge.state_dict_from_flax(
        jax.device_get(state.params["generator"])).items()}
    return ref


def one_process_references(inputs: dict) -> dict:
    """The same generator and discriminator without the split, on the whole
    batch in this process: output and gradients."""
    ref = {}
    cfg = PGGANConfig(**dict(CP_MODEL, attention_context_parallel=False))
    for name, net, x in (("gen", pggan.Generator(cfg), inputs["code"]),
                         ("dis", pggan.Discriminator(cfg), inputs["images"])):
        net.load_state_dict(inputs[f"{name}_weights"])
        y = net(x)
        torch.sum(torch.square(y.float())).backward()
        ref[f"{name}_cp"] = y.detach().numpy()
        ref[f"{name}_cp_grads"] = {k: p.grad.numpy() for k, p in net.named_parameters()}
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel")
    inputs = make_inputs()
    path = str(root / "inputs.pt")
    torch.save(inputs, path)
    procs = worker.spawn("parallel", path, str(root / "out"), world=WORLD)
    try:
        ref = jax_references(inputs)
        ref["one_process"] = one_process_references(inputs)
        ref["draws"] = worker.drawn_steps(inputs)
        ref["augment"] = worker.augmented(inputs)
    except BaseException:
        worker.kill(procs)
        raise
    return worker.collect(procs, str(root / "out")), ref, inputs


def _joined(ranks, key):
    return np.concatenate([r[key].numpy() for r in ranks])


def _grad_sum(ranks, key):
    return {k: sum(r[key][k].numpy() for r in ranks) for k in ranks[0][key]}


@pytest.mark.parametrize("net", ["gen", "dis"])
def test_context_parallel_forward_matches_jax(runs, net):
    ranks, ref, _ = runs
    ours = _joined(ranks, f"{net}_cp")
    np.testing.assert_allclose(ours, ref["one_process"][f"{net}_cp"], **FWD)
    np.testing.assert_allclose(ours, ref[f"{net}_cp"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net", ["gen", "dis"])
def test_context_parallel_gradients_match_jax(runs, net):
    ranks, ref, _ = runs
    ours = _grad_sum(ranks, f"{net}_cp_grads")
    attention = [k for k in ours if "self_attention" in k and "kernel" in k]
    assert attention and all(np.abs(ours[k]).max() > 0 for k in attention)
    for theirs in (ref[f"{net}_cp_grads"], ref["one_process"][f"{net}_cp_grads"]):
        assert set(ours) == set(theirs)
        scale = max(float(np.max(np.abs(v))) for v in theirs.values())
        assert scale > 0
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-2, atol=2e-3 * scale,
                                       err_msg=k)
    # Against the port's own path without the split each leaf is held to
    # its own magnitude: the attention projections' gradients are too small
    # beside the largest for the global tolerance to see them.
    theirs = ref["one_process"][f"{net}_cp_grads"]
    scale = max(float(np.max(np.abs(v))) for v in theirs.values())
    for k in ours:
        leaf = float(np.max(np.abs(theirs[k])))
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-3,
                                   atol=1e-3 * leaf + 1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("case", ["gen_single", "gen_no_group"])
def test_one_process_and_no_group_take_the_local_path(runs, case):
    ranks, _, _ = runs
    for r in ranks:
        torch.testing.assert_close(r[case], r["gen_local"], rtol=0, atol=0)


def test_indivisible_positions_take_the_local_path(monkeypatch):
    """N = 64 positions over 3 processes: the layer runs locally and issues
    no collective (the registered group is no process group at all)."""
    cfg = PGGANConfig(**CP_MODEL)
    local = pggan.Generator(cfg.replace(attention_context_parallel=False))
    weights = _weights(local, 0)
    cp = pggan.Generator(cfg)
    cp.load_state_dict(weights)
    code = torch.rand(3, 4, 4, 16, generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(parallel, "world_size", lambda group=None: 3)
    parallel.set_current_group(object())
    try:
        with torch.no_grad():
            out = cp(code)
    finally:
        parallel.set_current_group(None)
    with torch.no_grad():
        torch.testing.assert_close(out, local(code), rtol=0, atol=0)


def test_synced_moments_match_jax(runs):
    ranks, ref, inputs = runs
    x = inputs["moments_x"].numpy()
    for r in ranks:
        np.testing.assert_allclose(r["moments"].numpy(), ref["moments"], atol=1e-5)
        np.testing.assert_allclose(r["moments"].numpy(),
                                   np.stack([x.mean((0, 1, 2)), x.var((0, 1, 2))]), atol=1e-5)


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_batch_norm_and_its_statistics_match_jax(runs, case):
    """Grouped: each process normalizes its group, the moving statistics
    and renorm EMAs advance with every group's moments. Synced (one
    group): the moments of the whole batch, which JAX's global view takes
    at one group without sync (its trainer cannot bind the sync axis)."""
    ranks, ref, _ = runs
    np.testing.assert_allclose(_joined(ranks, f"norm_{case}"), ref[f"norm_{case}"],
                               rtol=1e-5, atol=1e-5)
    for r in ranks:
        stats = r[f"norm_{case}_stats"]
        assert set(stats) == set(ref[f"norm_{case}_stats"])
        for k, v in ref[f"norm_{case}_stats"].items():
            np.testing.assert_allclose(stats[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ranks[0][f"norm_{case}_stats"]:
        torch.testing.assert_close(ranks[0][f"norm_{case}_stats"][k],
                                   ranks[1][f"norm_{case}_stats"][k], rtol=0, atol=0)


def test_dcgan_batch_norm_takes_the_global_moments(runs):
    """The alternative networks' batch norm (``models/plain_layers.py``, a
    DCGAN discriminator here) in train mode under the group: the whole
    batch's moments, as JAX's global view takes them (outputs rtol 1e-5 /
    atol 1e-5), the running moments after an updating call equal on both
    processes and to JAX's (atol 1e-6), and the whole batch's gradient,
    the processes' sum, within the gradient tolerance."""
    ranks, ref, _ = runs
    np.testing.assert_allclose(_joined(ranks, "dcgan_dis"), ref["dcgan_dis"], rtol=1e-5,
                               atol=1e-5)
    for r in ranks:
        stats = {k: v.numpy() for k, v in r["dcgan_dis_stats"].items()}
        assert set(stats) == set(ref["dcgan_dis_stats"]) and stats
        for k, v in ref["dcgan_dis_stats"].items():
            np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    ours, theirs = _grad_sum(ranks, "dcgan_dis_grads"), ref["dcgan_dis_grads"]
    assert set(ours) == set(theirs)
    scale = max(float(np.max(np.abs(v))) for v in theirs.values())
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-2, atol=2e-3 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["stddev", "stddev_fused"])
def test_minibatch_stddev_spans_the_processes(runs, case):
    ranks, ref, _ = runs
    groups = 3 if case == "stddev_fused" else 1

    def whole(key):  # each process holds its rows of each part
        parts = [np.split(r[key].numpy(), groups) for r in ranks]
        return np.concatenate([np.concatenate([p[i] for p in parts]) for i in range(groups)])

    np.testing.assert_allclose(whole(case), ref[case], **FWD)
    np.testing.assert_allclose(whole(f"{case}_grad"), ref[f"{case}_grad"], rtol=1e-4, atol=1e-6)


def test_data_parallel_g_step_matches_jax(runs):
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_allclose(float(r["dp_loss"]), ref["dp_loss"], rtol=1e-4)
        assert set(r["dp_params"]) == set(ref["dp_params"])
        for k, v in ref["dp_params"].items():
            np.testing.assert_allclose(r["dp_params"][k].numpy(), v, atol=1e-5, err_msg=k)
    for k in ranks[0]["dp_params"]:
        torch.testing.assert_close(ranks[0]["dp_params"][k], ranks[1]["dp_params"][k],
                                   rtol=0, atol=0)



@pytest.mark.parametrize("trainer", ["gan", "twingan"])
def test_draws_at_the_global_batch_make_two_processes_one(runs, trainer):
    """With every draw the trainer's own (z, the style, each pass's gdrop,
    the penalty's alpha and noise, the fused D pass's per part), two
    processes' steps take one process's gradients and metrics on the whole
    batch, up to the order of the sums."""
    ranks, ref, _ = runs
    theirs = ref["draws"][trainer]
    for r in ranks:
        ours = r["draws"][trainer]
        assert len(ours["grads"]) == len(theirs["grads"]) == 2
        for step_ours, step_theirs in zip(ours["grads"], theirs["grads"]):
            scale = max(float(g.abs().max()) for g in step_theirs)
            assert scale > 0
            for a, b in zip(step_ours, step_theirs):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4 * scale)
        assert set(ours["metrics"]) == set(theirs["metrics"])
        for k, v in theirs["metrics"].items():
            np.testing.assert_allclose(ours["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("parts", ["1", "2"])
def test_each_process_augments_its_rows_as_one_process_would(runs, parts):
    """The runner's augmentation of each process's rows alone, with its rows
    of the draws made for the whole batch, is one process's augmentation of
    the whole batch cut to those rows: each process copies and augments
    only its rows, and the crops, flips and colour factors stay per image.
    "2" is two batches end to end, the layout of a scan chunk."""
    ranks, ref, _ = runs
    whole = ref["augment"][parts]
    for r, rank in enumerate(ranks):
        mine = torch.cat([batch.chunk(WORLD)[r] for batch in whole.chunk(int(parts))])
        torch.testing.assert_close(rank["augment"][parts], mine, rtol=0, atol=0)


class TestMultiHost:
    """``initialize_from_env`` and the batch slicing, mirroring
    ``tests/test_parallel.py``'s ``TestMultiHost`` with torchrun's
    variables."""

    ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

    def test_single_process_noop(self, monkeypatch):
        for var in self.ENV:
            monkeypatch.delenv(var, raising=False)
        assert parallel.initialize_from_env("cpu") is False
        assert parallel.current_group() is None
        assert parallel.local_batch_slice(32) == slice(0, 32)
        monkeypatch.setenv("WORLD_SIZE", "1")
        assert parallel.initialize_from_env("cpu") is False

    def test_env_parsing_requests_init(self, monkeypatch):
        calls = {}
        monkeypatch.setattr(parallel.multihost, "init_group",
                            lambda *a, **kw: calls.update(args=a, **kw))
        for var, value in zip(self.ENV, ("2", "4", "2", "10.0.0.1", "1234")):
            monkeypatch.setenv(var, value)
        assert parallel.initialize_from_env("cpu", timeout_s=30) is True
        assert calls == {"args": ("cpu", 2, 4, "tcp://10.0.0.1:1234"), "timeout_s": 30,
                         "local_rank": 2}

    def test_env_without_an_address_raises_naming_torchrun(self, monkeypatch):
        for var in self.ENV:
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="torchrun"):
            parallel.initialize_from_env("cpu")

    def test_the_card_needs_cuda_and_nccl(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.init_group(None, 0, 1, "tcp://127.0.0.1:1")

    def test_batch_slices(self, monkeypatch):
        monkeypatch.setattr(parallel.multihost, "world_size", lambda group=None: 4)
        monkeypatch.setattr(parallel.multihost, "rank", lambda group=None: 2)
        group = object()
        assert parallel.local_batch_slice(32, group) == slice(16, 24)
        with pytest.raises(ValueError, match="not divisible by the process count 4"):
            parallel.local_batch_slice(30, group)
        x = torch.arange(24)
        assert parallel.local_rows(x, group=group).tolist() == [12, 13, 14, 15, 16, 17]
        # Three global batches end to end (a fused pass): this process's
        # rows of each.
        assert parallel.local_rows(x, parts=3, group=group).tolist() == [4, 5, 12, 13, 20, 21]
