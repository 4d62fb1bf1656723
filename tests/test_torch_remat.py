"""Remat in the port's trainers: a step under ``remat=True`` (every network
pass through ``torch.utils.checkpoint``, ``train/base.py:remat_call``)
equals the same step without it, and the recompute writes no state.

The JAX remat is pure; the port's state is written in place, so the traps
are the recompute writing the moving statistics, batch renorm's EMAs or a
spectral norm's ``u`` a second time (or reading them as the first call
left them), and noise drawn from a ``torch.Generator`` inside a pass.
These configurations have all of them: TwinGAN at 16 px under batch renorm
at step 10001 (where the clip bites), spectral norm in every network,
self-attention at 8 px, UNet, the style embedding, distillation and gdrop
at step 10001 with strength 0.05; GanTrainer with spectral norm, gdrop,
conditional labels, batch norm and a Polyak average. One G step and one D
step each, with the step's own random draws (DRAGAN's penalty
differentiates a checkpointed discriminator pass twice). Losses,
gradients and the whole state after each step are held within 1e-6 (they
are equal: the recompute runs the same ops on the same values), and the
networks' passes are counted to show that remat recomputes them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import attention  # noqa: E402
from twingan_tpu_torch.train import base  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.state import state_to_dict  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

TOL = 1e-6
STEP = 10001


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Recorder:
    """Keeps the gradients a side's optimizer is handed, then steps."""

    def __init__(self, inner):
        self.inner, self.names, self.params = inner, inner.names, inner.params
        self.cfg, self.grads = inner.cfg, None

    @property
    def count(self):
        return self.inner.count

    def slots(self):
        return self.inner.slots()

    def step(self, grads):
        self.grads = {n: g.detach().clone() for n, g in zip(self.names, grads)}
        self.inner.step(grads)


def twingan(remat):
    m = PGGANConfig(resolution=16, max_channels=8, num_domains=2, norm_type="batch_renorm",
                    equalized_lr=True, do_pixel_norm=True, do_self_attention=True,
                    self_attention_hw=8, spectral_norm=True,
                    spectral_norm_in_non_discriminator=True, style_dim=4)
    return TwinGANTrainer(TwinGANConfig(
        model=m, batch_size=2, use_unet=True, use_style_embedding=True, style_embed_size=4,
        do_encoder_distillation=True, source_embed_dim=5, use_gdrop=True, remat=remat,
        moving_average_decay=0.9), device="cpu")


def generation(remat):
    m = PGGANConfig(resolution=16, max_channels=8, norm_type="batch_norm", equalized_lr=True,
                    do_pixel_norm=True, spectral_norm=True, spectral_norm_in_non_discriminator=True)
    return GanTrainer(GanTrainerConfig(
        model=m, batch_size=2, use_gdrop=True, use_conditional_labels=True, num_classes=3,
        conditional_embed_dim=2, remat=remat, moving_average_decay=0.9), device="cpu")


def batch(program, seed):
    rs = np.random.RandomState(seed)
    img = lambda: torch.from_numpy(rs.rand(2, 16, 16, 3).astype(np.float32))  # noqa: E731
    if program == "twingan":
        return {"source": img(), "target": img(),
                "source_embedding": torch.from_numpy(rs.randn(2, 5).astype(np.float32)),
                "target_embedding": torch.from_numpy(rs.randn(2, 5).astype(np.float32))}
    return {"target": img(), "conditional_labels": torch.tensor([2, 0])}


def run(program, remat):
    """One G and one D step from the same seeded state; -> (metrics, grads,
    flat state) after each step, and the passes of each network."""
    trainer = (twingan if program == "twingan" else generation)(remat)
    state = trainer.init_state(0)
    state.step, state.critic_step = STEP, 2 * STEP
    state.gdrop_strength = torch.tensor(0.05)
    calls = {}
    for name, net in state.nets.items():
        # A pre-hook: the recompute stops once it has what the backward needs,
        # before the end of the pass, where a forward hook would fire.
        net.register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    state.gen_opt, state.dis_opt = Recorder(state.gen_opt), Recorder(state.dis_opt)
    start = {k: v.clone() for k, v in state_to_dict(state).items()}
    out = []
    for kind in ("g_step", "d_step"):
        state, metrics = getattr(trainer, kind)(state, batch(program, 3), rng=7)
        opt = state.gen_opt if kind == "g_step" else state.dis_opt
        out.append((metrics, opt.grads, {k: v.clone() for k, v in state_to_dict(state).items()},
                    start))
    return out, calls


@pytest.fixture(scope="module", params=["twingan", "generation"])
def runs(request):
    return {remat: run(request.param, remat) for remat in (False, True)}


def test_remat_equals_no_remat(runs):
    (plain, _), (remat, _) = runs[False], runs[True]
    for (pm, pg, ps, _), (rm, rg, rs, _) in zip(plain, remat):
        assert set(pm) == set(rm)
        for k in pm:
            np.testing.assert_allclose(float(rm[k]), float(pm[k]), rtol=0, atol=TOL, err_msg=k)
        assert set(pg) == set(rg)
        for k in pg:
            np.testing.assert_allclose(rg[k].numpy(), pg[k].numpy(), rtol=0, atol=TOL,
                                       err_msg=k)
        assert set(ps) == set(rs)
        for k in ps:
            np.testing.assert_allclose(rs[k].float().numpy(), ps[k].float().numpy(), rtol=0,
                                       atol=TOL, err_msg=k)


def test_state_is_written_once(runs):
    """The G step moves the buffers a recompute could write twice (batch
    renorm's EMAs, moving statistics, spectral vectors) from where they
    started, and by the same amount with and without remat
    (``test_remat_equals_no_remat``): the recompute wrote none."""
    (plain, _), _ = runs[False], runs[True]
    start = plain[0][3]
    buffers = [k for k in start if "renorm_" in k or k.endswith("/u") or "/moving_" in k]
    assert buffers
    moved = [k for k in buffers if not torch.equal(plain[0][2][k], start[k])]
    assert len(moved) > len(buffers) // 4, (len(moved), len(buffers))


def test_remat_recomputes_the_passes(runs):
    """Under remat every differentiated pass runs again in the backward
    (each network's pre-hook fires in the recompute too)."""
    (_, plain_calls), (_, remat_calls) = runs[False], runs[True]
    assert set(plain_calls) == set(remat_calls)
    assert all(remat_calls[k] > plain_calls[k] for k in plain_calls), (plain_calls,
                                                                       remat_calls)


def test_remat_call_without_grad_is_the_plain_call():
    net = torch.nn.Linear(3, 2)
    x = torch.rand(4, 3)
    with torch.no_grad():
        assert torch.equal(base.remat_call(net, (net,), x), net(x))


def test_attention_runs_again_in_the_recompute(monkeypatch):
    """The launch counts of remat (chip_smoke.py's expected launches): each
    differentiated pass of a network with self-attention runs the forward
    twice, its backward once."""
    calls = []
    real = attention.self_attention

    def counting(f, g, h, route="kernel"):
        calls.append((route, torch.is_grad_enabled()))
        return real(f, g, h, route)

    monkeypatch.setattr(attention, "self_attention", counting)
    counts = {}
    for remat in (False, True):
        calls.clear()
        trainer = twingan(remat)
        state = trainer.init_state(0)
        trainer.g_step(state, batch("twingan", 4))
        counts[remat] = len(calls)
    assert counts[True] == 2 * counts[False]


def load_smoke():
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("norm", ["batch_norm", "instance_norm"])
def test_chip_smoke_expected_launches_count_the_recompute(monkeypatch, norm, remat):
    """chip_smoke.py's launch counts for the options: the style encoder's
    passes, the fused and unfused passes, and remat's recompute (a second
    forward per differentiated pass, two more per penalty pass), against
    the attention calls a G and a D step make at 64 px (the cycle terms on)
    on the CPU, where each call's route and grad mode are recorded."""
    smoke = load_smoke()
    calls = []
    real = attention.self_attention

    def counting(f, g, h, route="kernel"):
        calls.append((route, torch.is_grad_enabled()))
        return real(f, g, h, route)

    monkeypatch.setattr(attention, "self_attention", counting)
    m = PGGANConfig(resolution=64, max_channels=8, num_domains=2, norm_type=norm,
                    do_self_attention=True, self_attention_hw=16, style_dim=4)
    trainer = TwinGANTrainer(TwinGANConfig(
        model=m, batch_size=2, use_unet=True, use_style_embedding=True, style_embed_size=4,
        do_encoder_distillation=True, source_embed_dim=5, use_gdrop=True, remat=remat),
        device="cpu")
    state = trainer.init_state(0)
    expected = smoke.expected_launches(trainer, state.nets)
    b = {k: torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(i))
         for i, k in enumerate(("source", "target"))}
    for kind in ("g_step", "d_step"):
        calls.clear()
        getattr(trainer, kind)(state, b)
        kernel = [grad for route, grad in calls if route == "kernel"]
        differentiated = sum(kernel) // (2 if remat else 1)
        want = expected[kind]
        assert len(kernel) == want[attention.KERNEL_NAME], kind
        assert differentiated == want[attention.DQ_KERNEL] == want[attention.DKV_KERNEL]
        assert sum(route == "plain" for route, _ in calls) == want[attention.PLAIN_ROUTE]


def test_chip_smoke_options_comparison_on_the_cpu():
    """chip_smoke.py's options comparisons with the CPU standing in for the
    card, at 32 px: the TwinGAN options (style, distillation, gdrop, remat;
    float32 only, as the script holds them) and pggan with gdrop and
    conditional labels under rmsprop and, in a D step, ftrl (its updates
    held too); float32 against float32 agrees exactly, bf16 within the
    limits the script holds the card to."""
    smoke = load_smoke()
    cfg = smoke.options_config().replace(model=smoke.options_config().model.replace(
        resolution=32, max_channels=16, self_attention_hw=16))
    trainer = TwinGANTrainer(cfg, device="cpu")
    state = trainer.init_state(smoke.SEED)
    smoke.set_attention_gamma(state.nets)
    weights = {k: v.detach().clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    gp = {d: {"alpha": torch.rand(smoke.TRAIN_BATCH, 1, 1, 1, generator=gen),
              "noise": torch.rand(smoke.TRAIN_BATCH, 32, 32, 3, generator=gen) * 2 - 1}
          for d in ("s", "t")}
    rows = smoke.compare_steps(cfg, weights, [smoke._options_batch(rng, cfg, "cpu")
                                              for _ in range(2)], gp, card="cpu",
                               phase="options", limits=smoke.OPTIONS_TWINGAN_LIMITS,
                               step=smoke.OPTIONS_STEP,
                               gdrop_strength=smoke.OPTIONS_GDROP_STRENGTH,
                               step_kw=smoke.twingan_option_draws(trainer, 1))
    gcfg = smoke.options_generation_config("rmsprop", 4)
    gcfg = gcfg.replace(model=gcfg.model.replace(resolution=32))
    gtrainer = GanTrainer(gcfg, device="cpu")
    gstate = gtrainer.init_state(0)
    smoke.randomize_biases(gstate.nets, 0)
    gweights = {k: v.detach().clone() for k, v in gstate.nets.state_dict().items()}
    batches, zs, gp = smoke.generation_inputs(gcfg, 4, 3)
    for b in batches:
        b["conditional_labels"] = torch.tensor([0, 50, 7, 3])
    draws = smoke.generation_option_draws(gtrainer, 4, 3)
    kw = dict(card="cpu", phase="options", step=smoke.OPTIONS_STEP,
              gdrop_strength=smoke.OPTIONS_GDROP_STRENGTH, check_updates=True)
    rows += smoke.compare_generation_steps(gcfg, gweights, batches, zs, gp, step_kw=draws, **kw)
    rows += smoke.compare_generation_steps(
        gcfg.replace(opt=gcfg.opt.replace(optimizer="ftrl")), gweights, batches[1:],
        {"d_step": zs["d_step"]}, gp, step_kw={"d_step": draws["d_step"]},
        kinds=("d_step",), **kw)
    assert len(rows) == 2 + 4 + 2
    assert {"l_s_style", "l_source_distillation"} <= set(rows[0]["losses"])
    for row in rows:
        assert row["ok"], (row["check"], row["loss_abs_err"], row["grad_cosine"],
                           row["update_cosine"])
        if "float32 vs" in row["check"]:
            assert max(row["loss_abs_err"].values()) == 0.0
            assert all(c > 1 - 1e-9 for c in row["update_cosine"].values())
