"""Spectral normalization of the port against the JAX package's, in fp32 on
the CPU.

``power_iteration`` and ``spectral_normalize`` on seeded matrices and
vectors (the port takes its OIHW conv kernels and [in, out] dense kernels;
the JAX package a [in, out] reshape of HWIO); ``EqConv`` and ``EqDense``
with a spectral norm: the forward, the weight gradient (sigma on the live
weight, u and v without gradient) and the stored ``u``, with and without
an update; and the whole discriminator with spectral norm (self-attention
at 8 px, eq-lr, a growing stage): its prediction, every ``u`` after an
updating pass, the parameter gradients, and the bridge's round trip of the
``spectral`` collection. Then the u the port's TwinGAN G step threads
through its updating passes with spectral norm in every network: the
encoder's two passes and the generator's four (two when the passes are
fused) each advance u from what the last one wrote, so the u after the
step is that many JAX power iterations from the u before it, on the
weights before the step; the D step leaves them. Inputs come from numpy seeds. Tolerances: 1e-6
relative to the largest magnitude for single ops, u and sigma; 1e-5 for
the discriminator's prediction and gradients (a dozen layers whose fp32
sums XLA and ATen take in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu import ops as jops  # noqa: E402
from twingan_tpu.models import layers as jlayers  # noqa: E402
from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import layers, pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import sn  # noqa: E402

OP_TOL = 1e-6
NET_TOL = 1e-5


def close(got, ref, tol=OP_TOL, msg=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=msg)


def _unit(rng, n):
    u = rng.randn(n).astype(np.float32)
    return u / np.linalg.norm(u)


@pytest.mark.parametrize("iters", [1, 3])
def test_power_iteration_matches(iters):
    rng = np.random.RandomState(iters)
    w = rng.randn(12, 7).astype(np.float32)
    u = _unit(rng, 7)
    s_ref, u_ref, v_ref = jops.power_iteration(jnp.asarray(w), jnp.asarray(u), iters)
    s, u_new, v = sn.power_iteration(torch.from_numpy(w), torch.from_numpy(u), iters)
    close(s.numpy(), s_ref)
    close(u_new.numpy(), u_ref)
    close(v.numpy(), v_ref)


def test_power_iteration_gradient_is_the_envelope():
    """d sigma / dW = v u' with u and v held: the JAX package's stopped
    form, not the TF original's differentiable iteration."""
    rng = np.random.RandomState(4)
    w = rng.randn(6, 5).astype(np.float32)
    u = _unit(rng, 5)
    g_ref = jax.grad(lambda m: jops.power_iteration(m, jnp.asarray(u))[0])(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    sigma, u_new, v = sn.power_iteration(wt, torch.from_numpy(u))
    (g,) = torch.autograd.grad(sigma, wt)
    close(g.numpy(), g_ref)
    close(g.numpy(), torch.outer(v, u_new).numpy())
    assert not u_new.requires_grad and not v.requires_grad


@pytest.mark.parametrize("shape", [(3, 3, 4, 6), (1, 1, 5, 2), (4, 4, 3, 8), (9, 4)])
def test_spectral_normalize_matches(shape):
    """The port's layout (OIHW, or [in, out]) against the JAX package's
    HWIO reshape: the same W / sigma and the same new u."""
    rng = np.random.RandomState(len(shape) + shape[-1])
    w = rng.randn(*shape).astype(np.float32)
    u = _unit(rng, shape[-1])
    w_ref, u_ref = jops.spectral_normalize(jnp.asarray(w), jnp.asarray(u))
    wp = torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if w.ndim == 4 else w)
    w_sn, u_new = sn.spectral_normalize(wp, torch.from_numpy(u))
    got = w_sn.numpy().transpose(2, 3, 1, 0) if w.ndim == 4 else w_sn.numpy()
    close(got, w_ref)
    close(u_new.numpy(), u_ref)
    # Without an update the JAX function hands back the old u; the port's
    # caller keeps it by not storing the new one.
    assert np.array_equal(np.asarray(jops.spectral_normalize(
        jnp.asarray(w), jnp.asarray(u), update=False)[1]), u)


def _layer_pair(kind, eq_lr, seed):
    rng = np.random.RandomState(seed)
    if kind == "conv":
        x = rng.randn(2, 6, 6, 5).astype(np.float32)
        jmod = jlayers.EqConv(features=4, kernel_size=3, equalized_lr=eq_lr, spectral_norm=True)
        pmod = layers.EqConv(5, 4, 3, equalized_lr=eq_lr, spectral_norm=True)
        px = torch.from_numpy(x).permute(0, 3, 1, 2)
    else:
        x = rng.randn(3, 7).astype(np.float32)
        jmod = jlayers.EqDense(features=4, equalized_lr=eq_lr, spectral_norm=True)
        pmod = layers.EqDense(7, 4, equalized_lr=eq_lr, spectral_norm=True)
        px = torch.from_numpy(x)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    params = dict(variables["params"], bias=rng.randn(4).astype(np.float32))
    spectral = variables["spectral"]
    pmod.load_state_dict(bridge.state_dict_from_flax(params, spectral=spectral), strict=True)
    return x, px, jmod, pmod, params, spectral


def _nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


@pytest.mark.parametrize("kind", ["conv", "dense"])
@pytest.mark.parametrize("eq_lr", [False, True])
@pytest.mark.parametrize("update", [True, False])
def test_layer_with_spectral_norm_matches(kind, eq_lr, update):
    x, px, jmod, pmod, params, spectral = _layer_pair(kind, eq_lr, 3 + eq_lr)
    t = np.random.RandomState(9).randn(*jmod.apply(
        {"params": params, "spectral": spectral}, jnp.asarray(x)).shape).astype(np.float32)

    def loss(p):
        out, new = jmod.apply({"params": p, "spectral": spectral}, jnp.asarray(x),
                              mutable=["spectral"] if update else False) if update else (
            jmod.apply({"params": p, "spectral": spectral}, jnp.asarray(x)), None)
        return jnp.sum(out * jnp.asarray(t)), (out, new)

    (_, (ref, new)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    y = pmod(px, update=update)
    (g,) = torch.autograd.grad(torch.sum(_nhwc(y) * torch.from_numpy(t)), pmod.kernel)
    close(_nhwc(y).detach().numpy(), ref)
    g_ref = np.asarray(grads["kernel"])
    close(g.numpy(), g_ref.transpose(3, 2, 0, 1) if g_ref.ndim == 4 else g_ref)
    u_ref = np.asarray(new["spectral"]["u"]) if update else spectral["u"]
    close(pmod.u.numpy(), u_ref)
    assert np.array_equal(pmod.u.numpy(), spectral["u"]) == (not update)


def test_reset_draws_a_unit_u():
    mod = layers.EqConv(5, 4, 3, spectral_norm=True)
    layers.reset_parameters(mod, torch.Generator().manual_seed(0))
    assert float(torch.linalg.vector_norm(mod.u)) == pytest.approx(1.0, abs=1e-6)
    assert "u" not in layers.EqConv(5, 4, 3).state_dict()


DIS_KW = dict(resolution=16, is_growing=True, max_channels=8, equalized_lr=True,
              do_self_attention=True, self_attention_hw=8, spectral_norm=True)


@pytest.fixture(scope="module")
def discriminators():
    jcfg, pcfg = JaxPGGANConfig(**DIS_KW), PGGANConfig(**DIS_KW)
    rng = np.random.RandomState(2)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    jdis = jpggan.Discriminator(jcfg)
    variables = jax.device_get(jax.jit(jdis.init)({"params": jax.random.PRNGKey(0),
                                                   "gdrop": jax.random.PRNGKey(1)},
                                                  jnp.asarray(x)))
    params = jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0.0, 0.1, v.shape)).astype(np.float32), variables["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    params = _set_sa_gamma(params)
    spectral = variables["spectral"]
    pdis = pggan.Discriminator(pcfg)
    pdis.load_state_dict(bridge.state_dict_from_flax(params, spectral=spectral), strict=True)
    return dict(jdis=jdis, pdis=pdis, params=params, spectral=spectral, x=x)


def _set_sa_gamma(tree):
    return {k: (_set_sa_gamma(v) if isinstance(v, dict) else
                (np.full(v.shape, 0.7, np.float32) if k == "sa_gamma" else v))
            for k, v in tree.items()}


def test_discriminator_with_spectral_norm_matches(discriminators):
    d = discriminators
    x = d["x"]

    def loss(p):
        (pred, _), new = d["jdis"].apply({"params": p, "spectral": d["spectral"]}, jnp.asarray(x),
                                         alpha=0.3, train=True, mutable=["spectral"],
                                         rngs={"gdrop": jax.random.PRNGKey(2)})
        return jnp.sum(pred), (pred, new)

    (_, (ref, new)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(d["params"])
    pdis = d["pdis"]
    pred = pdis(torch.from_numpy(x), alpha=0.3, update=True)
    params = dict(pdis.named_parameters())
    got = torch.autograd.grad(pred.sum(), list(params.values()))
    close(pred.detach().numpy(), ref, NET_TOL)
    ref_grads = bridge.state_dict_from_flax(jax.device_get(grads))
    for (name, _), g in zip(params.items(), got):
        close(g.numpy(), ref_grads[name].numpy(), NET_TOL, name)
    ref_u = bridge.state_dict_from_flax({}, spectral=jax.device_get(new["spectral"]))
    port_u = {k: v for k, v in pdis.state_dict().items() if k.endswith("u")}
    assert set(port_u) == set(ref_u) and len(port_u) == 12
    for k in ref_u:
        close(port_u[k].numpy(), ref_u[k].numpy(), OP_TOL, k)


def test_discriminator_spectral_state_bridges_back(discriminators):
    params, collections = bridge.flax_train_state(
        {f"discriminator.{k}": v for k, v in discriminators["pdis"].state_dict().items()},
        ("discriminator",))
    assert set(collections["discriminator"]) == {"spectral"}
    flat = bridge._flatten(collections["discriminator"]["spectral"])
    assert len(flat) == 12 and all(k.endswith("u") for k in flat)
    back = bridge.state_dict_from_flax(params["discriminator"],
                                       spectral=collections["discriminator"]["spectral"])
    for k, v in discriminators["pdis"].state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("norm_type,gen_passes", [("batch_renorm", 4), ("instance_norm", 2)])
def test_twingan_g_step_threads_u_through_its_passes(norm_type, gen_passes):
    from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer

    cfg = TwinGANConfig(model=PGGANConfig(resolution=16, max_channels=8, num_domains=2,
                                          norm_type=norm_type, do_pixel_norm=True,
                                          spectral_norm=True,
                                          spectral_norm_in_non_discriminator=True),
                        batch_size=2, use_unet=True)
    assert cfg.fuse == (gen_passes == 2)
    trainer = TwinGANTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    before = {k: v.clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))
             for k in ("source", "target")}
    state, _ = trainer.g_step(state, batch)
    after_g = {k: v.clone() for k, v in state.nets.state_dict().items()}
    state, _ = trainer.d_step(state, batch)
    passes = {"encoder_content": 2, "generator": gen_passes}
    checked = 0
    for key, u in after_g.items():
        net = key.split(".", 1)[0]
        if not key.endswith(".u") or net not in passes:
            continue
        kernel = before[key[:-1] + "kernel"].numpy()
        w = kernel.transpose(2, 3, 1, 0) if kernel.ndim == 4 else kernel
        ref = jnp.asarray(before[key].numpy())
        for _ in range(passes[net]):
            _, ref = jops.spectral_normalize(jnp.asarray(w), ref)
        close(u.numpy(), ref, msg=key)
        # The D step's generator passes do not update.
        assert torch.equal(state.nets.state_dict()[key], u), key
        checked += 1
    assert checked == 5 + 7  # encoder: from_rgb and two blocks of two; generator: 3 blocks, to_rgb

