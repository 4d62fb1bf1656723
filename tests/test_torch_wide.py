"""SAGAN attention at every width the JAX layers produce, held against the
JAX package on the CPU.

The attention kernels (B1-B3) take any c_bar and C: past c_bar 64, or C
256, their C entry points launch ``csrc/flash_wide.cuh``'s kernels, which
cut every operand into chunks of 64 columns (the card's side is
``chip_smoke.py``'s kernel rows and its ``wide`` phase). Here:

- the wrapper's checks take the wide shapes (c_bar 128, C 1024) and
  (c_bar 256, C 2048), which they refused while the kernels had caps;
- the port's attention forward and backward through the CPU route (the
  layer's dispatch and the kernel wrappers' plain versions) at C 1024,
  c_bar 128, against ``twingan_tpu/ops/attention.py``'s ``attention_core``
  and its VJP in fp32, to 1e-5 of each output's largest magnitude;
- a model of the wide tensor-core kernels' rounding (one warp a row of 16,
  every 64-row tile in order: the forward's probabilities, dq's ds and
  dkv's p and ds rounded to bf16 per tile as the last product's operand,
  fp32 sums, each output rounded once), fed the same bf16-valued inputs as
  the Pallas kernels in interpret mode, within ``chip_smoke.py``'s
  tolerances;
- a TwinGAN translate at 8 px with max_channels 512 and attention at 8 px
  (C 512, c_bar 64 in the encoder and the generator, the published PGGAN's
  width), weights drawn in the port and carried to JAX by ``bridge.py``,
  against the JAX ``TwinGANTrainer.translate`` in fp32 to 1e-4 of the
  output's largest magnitude;
- the configurations of ``chip_smoke.py``'s wide phase, and its kernel
  rows, give the widths they claim.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.ops import attention as jattention  # noqa: E402
from twingan_tpu.train.state import GanTrainState  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer  # noqa: E402

from twingan_tpu_torch.bridge import flax_train_state  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.models.layers import reset_parameters  # noqa: E402
from twingan_tpu_torch.ops import attention  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import (  # noqa: E402
    ENC,
    GEN,
    TwinGANConfig,
    TwinGANTranslator,
    translate,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 64  # other-side rows a tile of the wide kernels
CPU_RTOL = 1e-5
TRANSLATE_SHARE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _inputs(b, n, c_bar, c, seed, scale=1.0, bf16=False):
    """f, g, h, do drawn with numpy from ``seed`` (f and g times ``scale``),
    optionally rounded to bf16 values."""
    rng = np.random.RandomState(seed)
    draw = [(rng.randn(b, n, w) * (scale if i < 2 else 1.0)).astype(np.float32)
            for i, w in enumerate((c_bar, c_bar, c, c))]
    return [_bf16(torch.from_numpy(x)).numpy() for x in draw] if bf16 else draw


def _max_err(a, ref) -> tuple[float, float]:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max()), float(np.abs(ref).max())


@pytest.mark.parametrize("c_bar,c", [(128, 1024), (256, 2048)])
def test_kernel_args_take_every_width(c_bar, c):
    """The checks every kernel call passes take c_bar and C past 64 and 256;
    what they still refuse is an empty tensor or more batch rows than the
    grid holds."""
    f, g = torch.zeros(2, 16, c_bar), torch.zeros(2, 16, c_bar)
    h = torch.zeros(2, 16, c)
    attention._check_kernel_args(attention.KERNEL_NAME, f, h, g)
    lse = delta = torch.zeros(2, 16)
    attention._check_backward(f, g, h, h.clone(), lse, delta)
    with pytest.raises(ValueError, match="non-empty"):
        attention._check_kernel_args(attention.KERNEL_NAME, f[:, :0], h[:, :0], g[:, :0])


def test_cpu_route_matches_jax_at_c_1024():
    """C 1024, c_bar 128 (a 1024-channel layer's attention, at 4 px):
    forward and backward through the layer's dispatch and through the
    kernel wrappers' plain versions, against the JAX einsum path and its
    VJP."""
    b, n, c_bar, c = 2, 16, 128, 1024
    f, g, h, do = _inputs(b, n, c_bar, c, seed=1, scale=0.3)
    ref_o, vjp = jax.vjp(jattention.attention_core, *map(jnp.asarray, (f, g, h)))
    refs = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (f, g, h)]
    tdo = torch.from_numpy(do)
    attention.reset_launch_counts()
    o = attention.self_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, tdo)
    tf, tg, th = (torch.from_numpy(x) for x in (f, g, h))
    o2, lse = attention.flash_attention_forward(tf, tg, th)
    delta = torch.sum(tdo * o2, dim=-1)
    grads2 = attention.flash_attention_backward(tf, tg, th, tdo, lse, delta)
    assert not any(attention.launch_counts.values())
    for out in (o.detach(), o2):
        err, ref_max = _max_err(out, ref_o)
        assert err <= CPU_RTOL * ref_max, (err, ref_max)
    for name, a, a2, ref in zip(("df", "dg", "dh"), grads, grads2, refs):
        for got in (a, a2):
            err, ref_max = _max_err(got, ref)
            assert err <= CPU_RTOL * ref_max, (name, err, ref_max)


def wide_forward_model(f, g, h):
    """(o, lse) as the wide tensor-core forward rounds them: one warp takes
    every 64-key tile of its rows in order, each tile's probabilities
    rounded to bf16 against the running max, l from the fp32 ones, o
    rounded once."""
    b, n, _ = f.shape
    s_all = f @ g.transpose(1, 2)
    m = torch.full((b, n), -torch.inf)
    l = torch.zeros(b, n)
    acc = torch.zeros(b, n, h.shape[-1])
    for k0 in range(0, n, TILE):
        s = s_all[:, :, k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(-1)
        acc = acc * scale[..., None] + _bf16(p) @ h[:, k0:k0 + TILE]
        m = m_new
    return _bf16(acc / l[..., None]), m + torch.log(l)


def wide_backward_model(f, g, h, do, lse, delta):
    """(df, dg, dh) as the wide tensor-core dq and dkv round them: ds (and
    dkv's p) rounded to bf16 per 64-row tile of the other side, fp32 sums
    over the tiles in order, each output rounded once."""
    n = f.shape[1]
    p = torch.exp(f @ g.transpose(1, 2) - lse[..., None])
    ds = p * (do @ h.transpose(1, 2) - delta[..., None])
    df, dg, dh = torch.zeros_like(f), torch.zeros_like(g), torch.zeros_like(h)
    for t0 in range(0, n, TILE):
        t = slice(t0, t0 + TILE)
        df += _bf16(ds[:, :, t]) @ g[:, t]
        dg += _bf16(ds[:, t]).transpose(1, 2) @ f[:, t]
        dh += _bf16(p[:, t]).transpose(1, 2) @ do[:, t]
    return _bf16(df), _bf16(dg), _bf16(dh)


def test_wide_rounding_model_within_chip_tolerance(smoke):
    """The wide kernels' path at c_bar 128, C 1024 (the forward model's bf16
    output and lse, delta = rowsum(do o), the backward model) against the
    Pallas forward and backward (interpret mode, fp32) on the same
    bf16-valued inputs: within tolerance("bfloat16"), the 1e-4 logsumexp
    check and grad_tolerance("bfloat16") of chip_smoke.py."""
    b, n, c_bar, c = 1, 256, 128, 1024
    f, g, h, do = _inputs(b, n, c_bar, c, seed=2, bf16=True)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_o, ref_lse = jattention._flash_forward(jf, jg, jh, 128, 128)
    ref_delta = jnp.sum(jdo * ref_o, axis=-1)
    refs = jattention._flash_backward(jf, jg, jh, jdo, ref_lse, ref_delta, 128, 128)
    tf, tg, th, tdo = map(torch.from_numpy, (f, g, h, do))
    o, lse = wide_forward_model(tf, tg, th)
    err, ref_max = _max_err(o, ref_o)
    assert 0 < err <= smoke.tolerance("bfloat16", ref_max), (err, ref_max)
    lse_err, lse_max = _max_err(lse, ref_lse)
    assert lse_err <= 1e-4 * max(1.0, lse_max), lse_err
    grads = wide_backward_model(tf, tg, th, tdo, lse, torch.sum(tdo * o, dim=-1))
    for name, got, ref in zip(("df", "dg", "dh"), grads, refs):
        err, ref_max = _max_err(got, ref)
        assert 0 < err <= smoke.grad_tolerance("bfloat16", ref_max, n), (name, err, ref_max)


def test_wide_kernel_source():
    """Both attention libraries include the wide kernels (bf16 on the
    tensor cores: the forward's wide_mma_kernel, dq's and dkv's
    wide_bf16_kernel; fp32 on the TF32 tensor cores); wide_mma_kernel has
    no dq or dkv instance left; their C entry points keep no width cap, only
    the grid's batch limit."""
    def source(name):
        with open(os.path.join(REPO, "twingan_tpu_torch", "csrc", name)) as fh:
            return fh.read()

    wide = source("flash_wide.cuh")
    for op in ("wide_mma_kernel", "wide_bf16_kernel", "wide_tf32_kernel", "mma16816(",
               "ldmatrix_x4_trans(", "mma1688_tf32(", "cp_async16(", "ex2("):
        assert op in wide, op
    assert "atomicAdd" not in wide and "torch/" not in wide
    assert "wide_mma_kernel<kDq>" not in wide and "wide_mma_kernel<kDkv>" not in wide
    assert "wide_mma_kernel<M>" not in wide and "wide_mma_kernel<kFwd><<<" in wide
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        src = source(name)
        assert '#include "flash_wide.cuh"' in src
        assert "kMaxCbar" not in src and "kMaxC " not in src and "batch > 65535" in src


MODEL_KW = dict(resolution=8, max_channels=512, norm_type="batch_norm", equalized_lr=True,
                do_pixel_norm=True, num_domains=2, do_self_attention=True, self_attention_hw=8)
TRAINER_KW = dict(use_unet=True, batch_size=2, max_steps=1000)


def randomize(model, seed):
    """The JAX initializers' distributions, then every norm bank, moving
    statistic and bias drawn away from its init value and sa_gamma 0.7."""
    gen = torch.Generator().manual_seed(seed)
    reset_parameters(model, gen)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "sa_gamma":
                t.fill_(0.7)
            elif leaf.startswith(("gamma_", "moving_var_")):
                t.uniform_(0.5, 1.5, generator=gen)
            elif leaf.startswith(("beta_", "moving_mean_")) or leaf == "bias":
                t.normal_(0.0, 0.3, generator=gen)


def test_translate_at_512_channels_matches_jax():
    pcfg = TwinGANConfig(model=PGGANConfig(**MODEL_KW), **TRAINER_KW)
    model = TwinGANTranslator(pcfg)
    randomize(model, seed=3)
    attn = [m for m in model.modules() if type(m).__name__ == "SelfAttention"]
    assert len(attn) == 2
    params, model_state = flax_train_state(model.state_dict(), (ENC, GEN))
    zero = jnp.asarray(0, jnp.int32)
    state = GanTrainState(step=zero, critic_step=zero, params=params, model_state=model_state,
                          gen_opt_state=None, dis_opt_state=None,
                          gdrop_strength=jnp.asarray(0.0), gen_loss_ema=jnp.asarray(0.0))
    jtrainer = TwinGANTrainer(JaxTwinGANConfig(model=JaxPGGANConfig(**MODEL_KW), **TRAINER_KW))
    x = np.random.RandomState(4).rand(2, 8, 8, 3).astype(np.float32)
    ref = np.asarray(jtrainer.translate(state, jnp.asarray(x), "s2t"))
    model.eval()
    attention.reset_launch_counts()
    got = translate(pcfg, getattr(model, ENC), getattr(model, GEN), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 8, 8, 3)
    err, ref_max = _max_err(got, ref)
    assert err <= TRANSLATE_SHARE * ref_max, (err, ref_max)
    # The attention ran on the kernels' route (their plain version here)
    # and not the double-backward route.
    assert attention.launch_counts[attention.PLAIN_ROUTE] == 0


def test_chip_smoke_wide_configs(smoke):
    """The configurations of chip_smoke.py's wide phase give the widths it
    claims: C 512 (c_bar 64) at the 8 px attention, C 1024 (c_bar 128) at
    the generator's 4 px attention, and 2048 channels in every layer of the
    32 px pggan256, whose generator pass has 7 conv-leaky-pixel-norm layers;
    each wide attention shape is one of the kernel rows."""
    w512, w1024, w2048 = smoke.wide_configs()
    assert (w512.model.self_attention_hw, w512.model.channels(1)) == (8, 512)
    assert (w1024.model.self_attention_hw, w1024.model.channels(0)) == (4, 1024)
    assert w2048.model.resolution == smoke.WIDE_GEN_RESOLUTION == 32
    assert {w2048.model.channels(s) for s in range(w2048.model.max_stage + 1)} == {2048}
    assert 1 + 2 * w2048.model.max_stage == smoke.WIDE_GEN_LAYERS_PER_PASS
    shapes = {(c_bar, c) for _, _, _, c_bar, c, _ in smoke.KERNEL_CASES}
    assert {(64, 512), (128, 1024), (256, 2048)} <= shapes
    assert {(64, 512), (128, 1024), (256, 2048)} <= {
        (c_bar, c) for _, _, _, c_bar, c, _ in smoke.BWD_CASES}
    assert {1032, 1536, 2048} <= {row[4] for row in smoke.FUSED_CONV_CASES}
