"""Batch renorm, layer norm and the conditional norms of the port against
the JAX package's, in fp32 on the CPU.

The clipping schedule at its boundaries; ``batch_renorm_correction`` and
``renorm_moving_moments`` on seeded moments and state, per group and
whole-batch; ``DomainNorm`` of kind ``batch_renorm``, ``layer_norm`` and
``batch_norm``, with the bank's beta and gamma or with conditional ones
from a style vector, in train mode over three updating calls (two batch
groups, the state threaded from call to call on the JAX side and written
in place on the port's) and in eval mode. The renorm state is drawn from
a seed so that r and d are clipped in both directions (at the zero init r
is 1 and d is 0, and no clip would bite). Inputs come from numpy seeds.
Tolerance 1e-6 in fp32 for every output and every buffer, relative to its
largest magnitude (``close``): the conditional gamma is a matmul whose sum
XLA and ATen take in other orders, and gamma * y + beta then rounds at the
size of its largest terms (outputs up to 18 here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu import ops as jops  # noqa: E402
from twingan_tpu.models import layers as jlayers  # noqa: E402

from twingan_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from twingan_tpu_torch.models import layers  # noqa: E402
from twingan_tpu_torch.ops import norms  # noqa: E402

TOL = 1e-6
C = 6
STYLE_DIM = 5


def close(got, ref, msg=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=TOL * scale, err_msg=msg)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("step", [0, 9999, 10000, 10001, 20000, 30000, 30001])
def test_clipping_schedule_matches(step):
    ref = jops.renorm_clipping_schedule(jnp.asarray(step, jnp.int32))
    got = norms.renorm_clipping_schedule(step)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == float(ref[k]), (k, got[k], float(ref[k]))


def test_clipping_schedule_regimes():
    """values[i] while step <= boundaries[i]: the first regime holds
    through step 10000, the last starts after 30000."""
    pick = lambda s: norms.renorm_clipping_schedule(s)["dmax"]  # noqa: E731
    assert pick(10000) == pick(0) == np.float32(0.1)
    assert pick(10001) == pick(20000) == np.float32(0.3)
    assert pick(30001) == norms.last_renorm_clip()["dmax"] == 1.0


def _renorm_state(rng, c=C):
    """Biased EMAs whose debiased values lie far off the batch's moments
    (a log-normal stddev), so that r and d clip."""
    mw = np.float32(rng.uniform(0.85, 0.95))
    sw = np.float32(rng.uniform(0.85, 0.95))
    stddev = np.exp(rng.normal(0.0, 1.5, c))
    stddev[0] = 1e-3  # r near 1 / (1 - weight), past every rmax
    return {
        "renorm_mean": (rng.normal(0.0, 1.5, c) * mw).astype(np.float32),
        "renorm_mean_weight": np.asarray(mw, np.float32),
        "renorm_stddev": (stddev * sw).astype(np.float32),
        "renorm_stddev_weight": np.asarray(sw, np.float32),
    }


@pytest.mark.parametrize("groups", [0, 2])
@pytest.mark.parametrize("step", [0, 10001, None])
def test_batch_renorm_correction_matches(groups, step):
    rng = np.random.RandomState(11 + groups)
    c = 64
    shape = (groups, c) if groups else (c,)
    mean = rng.normal(0.0, 1.0, shape).astype(np.float32)
    var = rng.uniform(0.1, 3.0, shape).astype(np.float32)
    state = _renorm_state(rng, c)
    clip = norms.last_renorm_clip() if step is None else norms.renorm_clipping_schedule(step)
    jclip = (jops.renorm_clipping_schedule(jnp.asarray(step, jnp.int32)) if step is not None
             else clip)
    r_ref, d_ref, new_ref = jops.batch_renorm_correction(
        jnp.asarray(mean), jnp.asarray(var), {k: jnp.asarray(v) for k, v in state.items()},
        jclip)
    r, d, new = norms.batch_renorm_correction(
        torch.from_numpy(mean), torch.from_numpy(var),
        {k: torch.from_numpy(v) for k, v in state.items()}, clip)
    close(r.numpy(), np.asarray(r_ref))
    close(d.numpy(), np.asarray(d_ref))
    # The seeded state makes every clip bite.
    for bound in (clip["rmax"], clip["rmin"]):
        assert (np.asarray(r_ref) == np.float32(bound)).any(), bound
    assert (np.abs(np.asarray(d_ref)) == np.float32(clip["dmax"])).any()
    for k in state:
        close(new[k].numpy(), new_ref[k], k)
    m_ref, v_ref = jops.norms.renorm_moving_moments(new_ref)
    m, v = norms.renorm_moving_moments(new)
    close(m.numpy(), np.asarray(m_ref))
    close(v.numpy(), np.asarray(v_ref))


def _randomize(variables, rng):
    """Seeded values for every leaf of a DomainNorm's variables."""
    params, stats = {}, {}
    for k, v in variables["params"].items():
        if k.startswith("gamma_"):
            params[k] = rng.uniform(0.5, 1.5, v.shape)
        elif "_fc_" in k:
            params[k] = rng.normal(0.0, 0.3, v.shape)
        else:
            params[k] = rng.normal(0.0, 0.3, v.shape)
        params[k] = params[k].astype(np.float32)
    for d in range(2):
        if f"moving_mean_{d}" in variables.get("batch_stats", {}):
            stats[f"moving_mean_{d}"] = rng.normal(0.0, 0.3, C).astype(np.float32)
            stats[f"moving_var_{d}"] = rng.uniform(0.5, 1.5, C).astype(np.float32)
        if f"renorm_mean_{d}" in variables.get("batch_stats", {}):
            stats.update({f"{k}_{d}": v for k, v in _renorm_state(rng).items()})
    return params, stats


def build(kind, conditional, groups=2, seed=0):
    """A JAX DomainNorm and the port's on the same seeded variables."""
    rng = np.random.RandomState(seed)
    style = rng.normal(0.0, 1.0, (4, STYLE_DIM)).astype(np.float32) if conditional else None
    jmod = jlayers.DomainNorm(kind=kind, num_domains=2, num_groups=groups,
                              style_dim=STYLE_DIM if conditional else 0)
    x0 = np.zeros((4, 5, 5, C), np.float32)
    ctx = jlayers.NormCtx(domain=1, train=True,
                          style=None if style is None else jnp.asarray(style))
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x0), ctx))
    params, stats = _randomize(variables, rng)
    mod = layers.DomainNorm(kind, C, num_domains=2, num_groups=groups,
                            style_dim=STYLE_DIM if conditional else 0, conditional=conditional)
    mod.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jmod, mod, params, stats, style


CASES = [("batch_renorm", False), ("batch_renorm", True), ("layer_norm", False),
         ("layer_norm", True), ("batch_norm", True), ("instance_norm", True)]


@pytest.mark.parametrize("kind,conditional", CASES)
@pytest.mark.parametrize("step", [0, 10001])
def test_train_mode_three_updates_match(kind, conditional, step):
    """Three updating calls on three batches: each output, and the state
    after each call (the port writes in place; JAX threads it)."""
    jmod, mod, params, stats, style = build(kind, conditional)
    jclip = jops.renorm_clipping_schedule(jnp.asarray(step, jnp.int32))
    clip = norms.renorm_clipping_schedule(step)
    ctx = jlayers.NormCtx(domain=1, train=True, renorm_clip=jclip,
                          style=None if style is None else jnp.asarray(style))
    mod.train()
    rng = np.random.RandomState(3)
    for call in range(3):
        x = (rng.randn(4, 5, 5, C) * 2 + 1).astype(np.float32)
        variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
        mutable = ["batch_stats"] if stats else False
        out = jmod.apply(variables, jnp.asarray(x), ctx, mutable=mutable)
        ref, new_vars = out if mutable else (out, {})
        y = mod(nchw(x), 1, update=True,
                style=None if style is None else torch.from_numpy(style), clip=clip)
        close(nhwc(y), ref, f"call {call}")
        if stats:
            stats = jax.device_get(dict(new_vars["batch_stats"]))
            for k, v in stats.items():
                close(getattr(mod, k).numpy(), v, f"call {call}: {k}")
    if kind == "batch_renorm":
        assert float(mod.renorm_mean_weight_1) != float(mod.renorm_mean_weight_0)


@pytest.mark.parametrize("kind,conditional", CASES)
def test_train_mode_without_update_leaves_state(kind, conditional):
    """Train mode without ``update`` normalizes with the same r and d and
    writes nothing (the JAX update_state=False passes)."""
    jmod, mod, params, stats, style = build(kind, conditional, seed=4)
    x = (np.random.RandomState(5).randn(4, 5, 5, C) * 2 + 1).astype(np.float32)
    ctx = jlayers.NormCtx(domain=0, train=True,
                          style=None if style is None else jnp.asarray(style))
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
    ref = jmod.apply(variables, jnp.asarray(x), ctx, mutable=["batch_stats"] if stats else False)
    ref = ref[0] if stats else ref
    mod.train()
    y = mod(nchw(x), 0, style=None if style is None else torch.from_numpy(style))
    close(nhwc(y), np.asarray(ref))
    for k, v in stats.items():
        np.testing.assert_array_equal(getattr(mod, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("kind,conditional", CASES)
@pytest.mark.parametrize("domain", [0, 1])
def test_eval_mode_matches(kind, conditional, domain):
    jmod, mod, params, stats, style = build(kind, conditional, seed=6)
    x = (np.random.RandomState(7).randn(4, 5, 5, C) * 2 + 1).astype(np.float32)
    ctx = jlayers.NormCtx(domain=domain, train=False,
                          style=None if style is None else jnp.asarray(style))
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}
    ref = jmod.apply(variables, jnp.asarray(x), ctx)
    mod.eval()
    with torch.no_grad():
        y = mod(nchw(x), domain, style=None if style is None else torch.from_numpy(style))
    close(nhwc(y), np.asarray(ref))


def test_conditional_norm_needs_a_style_and_draws_xavier():
    mod = layers.DomainNorm("batch_renorm", 64, 2, style_dim=32, conditional=True).train()
    with pytest.raises(ValueError, match="style"):
        mod(torch.zeros(2, 64, 2, 2), 0)
    layers.reset_parameters(mod, torch.Generator().manual_seed(0))
    limit = (6.0 / (32 + 64)) ** 0.5
    k = mod.gamma_fc_kernel_1
    assert float(k.detach().abs().max()) <= limit and float(k.detach().abs().max()) > 0.9 * limit
    assert float(mod.gamma_fc_bias_1.detach().abs().max()) == 0.0
    assert set(mod.state_dict()) >= {"renorm_mean_weight_0", "renorm_stddev_weight_1"}
    assert mod.renorm_mean_weight_0.shape == ()
