"""PGGAN image-generation trainer, in PyTorch.

Counterpart of ``twingan_tpu/train/gan_trainer.py``: ``GanTrainerConfig``
field for field (same names, order and defaults, so the JAX
``config.json`` loads), and ``GanTrainer`` with the JAX entry points
(``init_state``, ``g_step``, ``d_step``, ``sample``, and from the base
``round_step``, ``scan_rounds`` and ``eval_metrics``). Networks
``generator`` (the noise-input PGGAN generator, or the CycleGAN or DCGAN
one) and ``discriminator``.

The steps follow the JAX ones:
- the G step: z -> generator (train mode, moving statistics updated) ->
  discriminator -> the generator's GAN loss; Adam on the generator; the
  gdrop state and the Polyak average of the generator's parameters;
- the D step: the generator's pass runs under ``torch.no_grad()`` (the JAX
  ``stop_gradient``) with no updates, so its conv-leaky-pixel-norm steps
  run kernel B4 on the card (``ops/fused_conv.py``); the discriminator on
  the fake and the real batch, the GAN terms, and the gradient penalty,
  whose pass takes the twice-differentiable plain attention route;
- ``sample``: eval mode, the Polyak-averaged parameters when
  ``moving_average_decay`` is set, no gradient (B4 again).

Batch renorm's clip comes from the state's global step in both steps. The
G step's generator pass moves its spectral norms' ``u`` (with
``spectral_norm_in_non_discriminator``); the discriminator's ``u``
advances once per D step, from the state before the step, which its fake,
real and penalty passes all read (``layers.advance_spectral_norm``), as
the JAX step's one updating pass does.

As in the JAX package each side's optimizer is built over the network's
own parameter paths, without the network's name (``block_4_conv0.conv.kernel``),
so a frozen scope matches the path inside the network; the discriminator's
schedule is stretched by ``max(1, n_critic - 1)``.

The generator's input is, in order: the step's ``z`` argument (injected
noise), the batch's ``"source"`` item (as in ``_gen_input``), or normal
noise of ``noise_shape`` drawn from ``step_generator(rng, critic_step)``.
The gradient penalty's draws come from the same generator unless the D
step is handed ``gp_noise``.

gdrop (``use_gdrop``): the strength follows ``update_gdrop_state`` in the
G step, and every discriminator pass (the G step's, and the D step's
fake, real and penalty passes, each with noise of its own) multiplies its
conv inputs by gdrop noise, drawn from the step's generator after z (and,
in the D step, before the penalty's draws), or injected whole as
``gdrop_noise`` ({"fake", "real", "gp"}: lists of [B, C] tensors in the
discriminator's site order). The JAX package draws each pass's noise from
``fold_in(k_gdrop, 0/1/2)``; the port's stream is its own.

Conditional labels (``use_conditional_labels``): the batch's
``"conditional_labels"`` (integer class ids, one-hot encoded, or
multi-hot [B, num_classes] vectors) are the style vector of the
generator's conditional norms (``style_dim`` is forced to
``num_classes``), and their product with ``cond_lookup``, a fixed
[num_classes, conditional_embed_dim] U(0, 1) matrix, is concatenated into
the discriminator at 4x4. ``cond_lookup`` is not checkpointed: it is
regenerated from the config as the JAX package draws it,
``jax.random.uniform(PRNGKey(num_classes * 1000003 +
conditional_embed_dim))``, bit for bit (``utils/threefry.py``).

Remat (``remat``) runs each generator and discriminator pass through
``base.remat_call``.

The other networks (``generator_network``, as the JAX trainer selects
them): ``cyclegan``, the CycleGAN ResNet generator and discriminator of
``cyclegan_num_channels`` filters (``models/cyclegan.py``), translating
the batch's ``"source"`` images, with the paired L1 term |target - fake|
added to the generator's loss; ``dcgan``, the DCGAN pair of depth
``dcgan_depth`` (``models/dcgan.py``), the generator ending at the model's
resolution and taking [B, dcgan_latent_dim] normal latents (an image
``"source"`` is ignored, a 2-D one is the latent). Their passes take no
alpha, gdrop, attention route or conditioning. Their batch norms
(DCGAN's) follow the JAX steps: every pass in train mode on its batch's
moments; the G step's generator pass moves the generator's running
moments, and the D step's fake pass the discriminator's. ``sample`` runs
the generator in eval mode (running moments).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from twingan_tpu_torch import parallel
from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.models.cyclegan import CycleGANDiscriminator, CycleGANGenerator
from twingan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from twingan_tpu_torch.models.layers import advance_spectral_norm, reset_parameters
from twingan_tpu_torch.models.pggan import Discriminator, Generator, noise_shape
from twingan_tpu_torch.train.base import (
    BaseGanTrainer,
    require_trainable,
    resolve_device,
    step_generator,
)
from twingan_tpu_torch.train.losses import (
    GanLossConfig,
    discriminator_gan_loss,
    generator_gan_loss,
    gradient_penalty,
    l1_loss,
)
from twingan_tpu_torch.train.optimizers import OptimizerConfig, build_optimizer, global_norm
from twingan_tpu_torch.train.state import GanTrainState, polyak_update, update_gdrop_state
from twingan_tpu_torch.utils import threefry
from twingan_tpu_torch.utils.misc import safe_one_hot_encoding

GEN = "generator"
DIS = "discriminator"
NETWORKS = ("pggan", "cyclegan", "dcgan")


@dataclasses.dataclass(frozen=True)
class GanTrainerConfig:
    model: PGGANConfig = dataclasses.field(default_factory=PGGANConfig)
    loss: GanLossConfig = dataclasses.field(default_factory=GanLossConfig)
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    batch_size: int = 16
    n_critic: int = 2
    use_ttur: bool = False
    discriminator_learning_rate: float = 0.0004
    use_gdrop: bool = False
    gdrop_coef: float = 0.2
    gdrop_lim: float = 0.5
    gdrop_exp: float = 2.0
    grow_start_step: int = 0
    max_steps: int = 300000
    generator_network: str = "pggan"
    cyclegan_num_channels: int = 64
    dcgan_depth: int = 64
    dcgan_latent_dim: int = 64
    moving_average_decay: float = 0.0
    remat: bool = False
    use_conditional_labels: bool = False
    num_classes: int = 0
    conditional_embed_dim: int = 32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class GanTrainer(BaseGanTrainer):
    """One generation stage's training, one optimizer per network. Runs on
    the CUDA card unless ``device="cpu"``."""

    def __init__(self, cfg: GanTrainerConfig, device: Optional[str | torch.device] = None):
        if cfg.generator_network not in NETWORKS:
            raise NotImplementedError(
                f"generator_network {cfg.generator_network!r} is not implemented")
        if cfg.use_conditional_labels:
            if cfg.generator_network != "pggan":
                raise ValueError("conditional labels require the pggan network")
            if cfg.num_classes <= 0:
                raise ValueError("use_conditional_labels requires num_classes > 0")
            if cfg.model.style_dim != cfg.num_classes:
                # The conditional norms take the label vector as their style.
                cfg = cfg.replace(model=cfg.model.replace(style_dim=cfg.num_classes))
        require_trainable(cfg)
        self.cfg = cfg
        self.is_pggan = cfg.generator_network == "pggan"
        self.device = resolve_device(device)
        self.dis_opt_cfg = (cfg.opt.replace(learning_rate=cfg.discriminator_learning_rate)
                            if cfg.use_ttur else cfg.opt)
        self.cond_lookup = None
        if cfg.use_conditional_labels:
            seed = cfg.num_classes * 1000003 + cfg.conditional_embed_dim
            self.cond_lookup = torch.from_numpy(threefry.uniform(
                threefry.prng_key(seed), (cfg.num_classes, cfg.conditional_embed_dim)
            )).to(self.device)

    def build_nets(self) -> nn.ModuleDict:
        cfg = self.cfg
        channels = cfg.model.image_channels
        if cfg.generator_network == "cyclegan":
            filters = cfg.cyclegan_num_channels
            return nn.ModuleDict({
                GEN: CycleGANGenerator(num_filters=filters, num_outputs=channels,
                                       input_channels=channels),
                DIS: CycleGANDiscriminator(num_filters=filters, input_channels=channels)})
        if cfg.generator_network == "dcgan":
            res = cfg.model.resolution
            return nn.ModuleDict({
                GEN: DCGANGenerator(depth=cfg.dcgan_depth, final_size=res,
                                    num_outputs=channels, latent_dim=cfg.dcgan_latent_dim),
                DIS: DCGANDiscriminator(depth=cfg.dcgan_depth, input_size=res,
                                        input_channels=channels)})
        cond = cfg.use_conditional_labels
        return nn.ModuleDict({
            GEN: Generator(cfg.model, noise_input=True, conditional=cond),
            DIS: Discriminator(cfg.model, do_gdrop=cfg.use_gdrop,
                               cond_embed_dim=cfg.conditional_embed_dim if cond else 0)})

    def init_state(self, seed: int = 0) -> GanTrainState:
        """Networks drawn from ``seed`` with the JAX initializers (the same
        distributions, not the same numbers; ``bridge.py`` loads a JAX
        state's), in train mode on the trainer's device."""
        nets = self.build_nets()
        reset_parameters(nets, torch.Generator().manual_seed(seed))
        return self.state_from_nets(nets)

    def state_from_nets(self, nets: nn.ModuleDict, step: int = 0,
                        critic_step: int = 0) -> GanTrainState:
        """A train state around ``nets`` with fresh optimizers."""
        cfg = self.cfg
        nets = nets.to(self.device).train()
        gen_params = dict(nets[GEN].named_parameters())
        zero = torch.zeros((), device=self.device)
        return GanTrainState(
            nets=nets,
            gen_opt=build_optimizer(cfg.opt, gen_params),
            # D updates n_critic-1 times per global step; its schedule is
            # stretched so decayed rates track the global step.
            dis_opt=build_optimizer(self.dis_opt_cfg, dict(nets[DIS].named_parameters()),
                                    updates_per_step=max(1, cfg.n_critic - 1)),
            gdrop_strength=zero.clone(), gen_loss_ema=zero.clone(),
            step=step, critic_step=critic_step,
            gen_ema_params=({k: p.detach().clone() for k, p in gen_params.items()}
                            if cfg.moving_average_decay else None),
        )

    # ------------------------------------------------------------------ #
    # Train steps
    # ------------------------------------------------------------------ #
    def _gen_input(self, batch: Mapping[str, torch.Tensor], generator: torch.Generator,
                   batch_size: int) -> torch.Tensor:
        """The batch's "source" item when present, else fresh noise. DCGAN
        takes [B, dcgan_latent_dim] latents: a 2-D source is one, an image
        source (an image dataset's, equal to its target) is ignored."""
        src = batch.get("source")
        shape = noise_shape(self.cfg.model, batch_size)
        if self.cfg.generator_network == "dcgan":
            if src is not None and src.dim() != 2:
                src = None
            shape = (batch_size, self.cfg.dcgan_latent_dim)
        if src is not None:
            return src.to(self.device, torch.float32)
        return parallel.draw_rows(torch.randn, shape, generator=generator, device=self.device)

    def _gen_pass(self, gen: nn.Module, z: torch.Tensor, alpha: float, update: bool,
                  step: int, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """One generator pass in train mode; the other networks take no
        alpha, renorm clip or style."""
        if not self.is_pggan:
            return self._apply(gen, z, update=update)
        return self._apply(gen, z, alpha=alpha, update=update,
                           renorm_clip=self._renorm_clip(step), style=labels)

    def _dis_pass(self, dis: nn.Module, x: torch.Tensor, update: bool = False,
                  **pggan_kw) -> torch.Tensor:
        """One discriminator pass; ``pggan_kw`` (alpha, gdrop, conditioning,
        the attention route) reach the PGGAN discriminator only."""
        if not self.is_pggan:
            return self._apply(dis, x, update=update)
        return self._apply(dis, x, update=update, **pggan_kw)

    def _real(self, batch: Mapping[str, torch.Tensor], alpha: float) -> torch.Tensor:
        return self.growing_image(batch["target"].to(self.device, torch.float32), alpha)

    def _cond(self, batch: Mapping[str, torch.Tensor]):
        """(the label vector for the generator's conditional norms, its
        embedding for the discriminator), or (None, None) without
        conditional labels."""
        cfg = self.cfg
        if not cfg.use_conditional_labels:
            return None, None
        labels = batch.get("conditional_labels")
        if labels is None:
            raise ValueError(
                "use_conditional_labels=True but the batch has no 'conditional_labels' item; "
                "check the dataset emits labels (text-tag datasets need a vocab_file)")
        labels = torch.as_tensor(labels, device=self.device)
        if labels.dim() == 2 and labels.shape[-1] != cfg.num_classes:
            raise ValueError(f"conditional_labels width {labels.shape[-1]} != "
                             f"num_classes {cfg.num_classes}")
        if labels.dim() == 1:
            labels = safe_one_hot_encoding(labels, cfg.num_classes)
        labels = labels.float()
        return labels, labels @ self.cond_lookup

    def g_step(self, state: GanTrainState, batch: Mapping[str, torch.Tensor], rng: int = 0,
               z: Optional[torch.Tensor] = None,
               gdrop_noise: Optional[Mapping[str, list]] = None):
        """One generator update. ``batch``: NHWC "target" images in [0, 1]
        (and optionally the generator's input as "source", and
        "conditional_labels"). ``gdrop_noise`` injects the discriminator
        pass's gdrop draws as ``{"fake": [...]}``. Returns (state,
        metrics); the state is updated in place."""
        cfg = self.cfg
        gen, dis = state.nets[GEN], state.nets[DIS]
        alpha = self._alpha(state.step)
        real = self._real(batch, alpha)
        generator = step_generator(rng, state.critic_step, self.device)
        z = (self._gen_input(batch, generator, real.shape[0]) if z is None
             else parallel.local_rows(z))
        labels, embed = self._cond(batch)
        noise = (self._gdrop_noise(dis, real.shape[0], generator, gdrop_noise, "fake")
                 if self.is_pggan else None)
        fake = self._gen_pass(gen, z.to(self.device), alpha, True, state.step, labels)
        pred = self._dis_pass(dis, fake, alpha=alpha, cond_embed=embed,
                              gdrop_strength=state.gdrop_strength, gdrop_noise=noise)
        loss = generator_gan_loss(cfg.loss, pred)
        if cfg.generator_network == "cyclegan":
            loss = loss + l1_loss(real, fake)  # the paired term
        grads = self._grads(loss, state.gen_opt.params)
        loss = self._global_metrics({"loss": loss})["loss"]
        grad_norm = global_norm(grads)
        state.gen_opt.step(grads)
        state.gen_loss_ema, strength = update_gdrop_state(
            state.gen_loss_ema, loss, state.step, cfg.gdrop_coef, cfg.gdrop_lim, cfg.gdrop_exp)
        if cfg.use_gdrop:
            state.gdrop_strength = strength
        if cfg.moving_average_decay:
            polyak_update(state.gen_ema_params,
                          dict(zip(state.gen_opt.names, state.gen_opt.params)),
                          cfg.moving_average_decay)
        state.step += 1
        state.critic_step += 1
        metrics = {"generator_loss": loss.detach(), "alpha": alpha,
                   "gdrop_strength": state.gdrop_strength, "generator_grad_norm": grad_norm}
        return state, metrics

    def d_step(self, state: GanTrainState, batch: Mapping[str, torch.Tensor], rng: int = 0,
               z: Optional[torch.Tensor] = None,
               gp_noise: Optional[Mapping[str, torch.Tensor]] = None,
               gdrop_noise: Optional[Mapping[str, list]] = None):
        """One discriminator update. ``gp_noise`` injects the gradient
        penalty's random numbers, ``{"alpha": [B,1,1,1], "noise": the
        images' shape}``, and ``gdrop_noise`` the gdrop draws of its fake,
        real and penalty passes (``{"fake", "real", "gp"}``); otherwise
        they are drawn from ``step_generator(rng, critic_step)``, as z is."""
        cfg = self.cfg
        gen, dis = state.nets[GEN], state.nets[DIS]
        alpha = self._alpha(state.step)
        real = self._real(batch, alpha)
        generator = step_generator(rng, state.critic_step, self.device)
        z = (self._gen_input(batch, generator, real.shape[0]) if z is None
             else parallel.local_rows(z))
        labels, embed = self._cond(batch)
        noise = {k: (self._gdrop_noise(dis, real.shape[0], generator, gdrop_noise, k)
                     if self.is_pggan else None) for k in ("fake", "real", "gp")}
        with torch.no_grad():
            fake = self._gen_pass(gen, z.to(self.device), alpha, False, state.step, labels)
        dis_kw = dict(alpha=alpha, cond_embed=embed, gdrop_strength=state.gdrop_strength)
        # The fake pass moves the other networks' running moments (the JAX
        # step's one updating pass); the PGGAN discriminator has none.
        fake_pred = self._dis_pass(dis, fake, update=not self.is_pggan,
                                   gdrop_noise=noise["fake"], **dis_kw)
        real_pred = self._dis_pass(dis, real, gdrop_noise=noise["real"], **dis_kw)
        losses = discriminator_gan_loss(cfg.loss, fake_pred, real_pred)
        gp = gp_noise or {}
        losses["gradient_penalty"] = gradient_penalty(
            cfg.loss, lambda x: self._dis_pass(dis, x, attention="plain",
                                               gdrop_noise=noise["gp"], **dis_kw),
            real, fake, alpha=parallel.local_rows(gp.get("alpha")),
            noise=parallel.local_rows(gp.get("noise")), generator=generator)
        total = sum(losses.values())
        grads = self._grads(total, state.dis_opt.params)
        advance_spectral_norm(dis)
        grad_norm = global_norm(grads)
        state.dis_opt.step(grads)
        state.critic_step += 1
        metrics = self._global_metrics({
            "discriminator_loss": total.detach(),
            "real_pred_mean": real_pred.detach().float().mean(),
            "fake_pred_mean": fake_pred.detach().float().mean(),
            **{k: v.detach() for k, v in losses.items()}})
        metrics["discriminator_grad_norm"] = grad_norm
        return state, metrics

    # ------------------------------------------------------------------ #
    # Sampling
    # ------------------------------------------------------------------ #
    def sample(self, state: GanTrainState, z: torch.Tensor,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inference-mode generation (moving statistics, no gradient) from
        noise ``z`` [B, noise_dim] or [B,1,1,noise_dim] (DCGAN: [B,
        dcgan_latent_dim]; CycleGAN: the NHWC source images), with the
        Polyak-averaged parameters when they are kept. ``labels`` is the
        conditioning vector [B, num_classes] of a conditional model (zeros
        when omitted). Returns NHWC images in the compute dtype."""
        gen = state.nets[GEN]
        was_training = gen.training
        gen.eval()
        try:
            with torch.no_grad():
                z = z.to(self.device, torch.float32)
                kw = {"alpha": self._alpha(state.step)} if self.is_pggan else {}
                if self.cfg.use_conditional_labels:
                    kw["style"] = (torch.zeros(z.shape[0], self.cfg.num_classes,
                                               device=self.device) if labels is None
                                   else torch.as_tensor(labels, device=self.device).float())
                if state.gen_ema_params is None:
                    return gen(z, **kw)
                return functional_call(gen, state.gen_ema_params, (z,), kw)
        finally:
            gen.train(was_training)
