"""TwinGAN trainer and translation, in PyTorch.

Counterpart of ``twingan_tpu/train/twingan_trainer.py``: ``TwinGANConfig``
field for field (same defaults and validation), ``TwinGANTrainer`` with the
JAX entry points (``init_state``, ``g_step``, ``d_step``, and from the base
``round_step``/``scan_rounds``), the encoder + generator pair a translation
needs (``TwinGANTranslator``, whose ``state_dict`` keys are the JAX
``params`` keys ``encoder_content`` / ``generator`` followed by the Flax
paths), and ``translate`` with the contract of ``TwinGANTrainer.translate``
for serving a stage; the method ``TwinGANTrainer.translate`` runs on a
train state (the runner's sample grids).

The step follows the JAX one pass for pass:
- four generator passes (s_prime = G_s(E_t(t)), t_prime = G_t(E_s(s)),
  s_cycle = G_s(E_s(s)), t_cycle = G_t(E_t(t))), fused into one pass per
  output domain when ``cfg.fuse`` (per-sample norms only);
- the G step updates the moving statistics in the JAX order, enc(s),
  enc(t), then s_prime, s_cycle, t_prime, t_cycle; the re-encodes of the
  primes and the discriminator passes inside it do not update;
- the D step's generator forward runs under ``torch.no_grad()`` (the JAX
  ``stop_gradient``) with train-mode statistics and no updates; its
  discriminator passes run real/prime/cycle (fused into one pass per
  domain with aligned minibatch-stddev groups when ``cfg.fuse``), and the
  gradient penalty's pass takes the plain attention route
  (``ops/attention.py``), the one twice-differentiable path.
- batch renorm's clip comes from the state's global step (which restarts
  at 0 each stage) in both steps; the G step's updating passes write the
  renorm EMAs in the order above, each pass computing r and d from what
  the earlier ones left; ``fuse`` stays off under batch renorm;
- spectral norms: the generator side's ``u`` advance in the G step's
  updating passes, in the same order; each discriminator's ``u`` advances
  once per D step, from the state before the step, which every one of the
  step's discriminator passes reads (``layers.advance_spectral_norm``).
Metric names are the JAX ones. Style embedding, encoder distillation,
gdrop and remat are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.models.layers import advance_spectral_norm, reset_parameters
from twingan_tpu_torch.models.pggan import Discriminator, Encoder, EncoderSkips, Generator
from twingan_tpu_torch.train.base import (
    BaseGanTrainer,
    fade_alpha,
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

ENC = "encoder_content"
GEN = "generator"
DIS_S = "discriminator_s"
DIS_T = "discriminator_t"

DOMAIN_S = 0
DOMAIN_T = 1


@dataclasses.dataclass(frozen=True)
class TwinGANConfig:
    model: PGGANConfig = dataclasses.field(
        default_factory=lambda: PGGANConfig(num_domains=2)
    )
    loss: GanLossConfig = dataclasses.field(default_factory=GanLossConfig)
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    batch_size: int = 8
    n_critic: int = 2
    use_ttur: bool = False
    discriminator_learning_rate: float = 0.0004
    use_gdrop: bool = False
    gdrop_coef: float = 0.2
    gdrop_lim: float = 0.5
    gdrop_exp: float = 2.0
    grow_start_step: int = 0
    max_steps: int = 300000
    l_cyc_weight: float = 1.0
    do_l_cyc_gan: bool = True
    l_content_weight: float = 0.1
    use_style_embedding: bool = False
    style_embed_size: int = 16
    use_unet: bool = False
    do_encoder_distillation: bool = False
    distillation_weight: float = 1.0
    distillation_start_hw: int = 16
    source_embed_dim: int = 0
    target_embed_dim: int = 0
    moving_average_decay: float = 0.0
    remat: bool = False
    fuse_passes: Optional[bool] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def batch_coupled_norm(self) -> bool:
        return self.model.norm_type.startswith(("batch_norm", "batch_renorm"))

    @property
    def fuse(self) -> bool:
        if self.fuse_passes is None:
            return not self.batch_coupled_norm
        return self.fuse_passes

    def __post_init__(self):
        if self.model.num_domains != 2:
            raise ValueError("TwinGAN requires model.num_domains == 2")
        if self.use_style_embedding and self.model.style_dim != self.style_embed_size:
            raise ValueError(
                "model.style_dim must equal style_embed_size when "
                "use_style_embedding is on"
            )
        if self.fuse_passes and self.batch_coupled_norm:
            raise ValueError(
                "fuse_passes=True with a batch-coupled norm "
                f"({self.model.norm_type}) would mix the per-pass batch "
                "moments; use per-sample norms or fuse_passes=False"
            )


class TwinGANTranslator(nn.Module):
    """The content encoder and the generator of a TwinGAN stage."""

    def __init__(self, cfg: TwinGANConfig):
        super().__init__()
        if cfg.use_style_embedding:
            raise NotImplementedError("use_style_embedding is not ported to twingan_tpu_torch yet")
        self.cfg = cfg
        self.add_module(ENC, Encoder(cfg.model))
        self.add_module(GEN, Generator(cfg.model, unet=cfg.use_unet))


def translate(cfg: TwinGANConfig, enc: Encoder, gen: Generator, images: torch.Tensor,
              direction: str = "s2t", step: int = 0) -> torch.Tensor:
    """Source-domain NHWC images in [0,1] -> target-domain images (or the
    reverse for ``direction='t2s'``), as ``TwinGANTrainer.translate``."""
    if direction not in ("s2t", "t2s"):
        raise ValueError(f"unknown direction {direction!r}")
    src_domain = DOMAIN_S if direction == "s2t" else DOMAIN_T
    out_domain = DOMAIN_T if direction == "s2t" else DOMAIN_S
    alpha = fade_alpha(cfg, step)
    with torch.inference_mode():
        code, skips = enc(images, alpha=alpha, domain=src_domain)
        return gen(code, alpha=alpha, domain=out_domain,
                   unet_skips=skips if cfg.use_unet else None)


class TwinGANTrainer(BaseGanTrainer):
    """One TwinGAN stage's training: networks ``encoder_content``,
    ``generator``, ``discriminator_s`` and ``discriminator_t``, one
    optimizer per side. Runs on the CUDA card unless ``device="cpu"``."""

    generator_side_keys = (ENC, GEN)
    discriminator_side_keys = (DIS_S, DIS_T)

    def __init__(self, cfg: TwinGANConfig, device: Optional[str | torch.device] = None):
        unported = [("use_style_embedding", cfg.use_style_embedding),
                    ("do_encoder_distillation", cfg.do_encoder_distillation)]
        for name, is_set in unported:
            if is_set:
                raise NotImplementedError(f"{name} is not ported to twingan_tpu_torch yet")
        require_trainable(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dis_opt_cfg = (cfg.opt.replace(learning_rate=cfg.discriminator_learning_rate)
                            if cfg.use_ttur else cfg.opt)

    def build_nets(self) -> nn.ModuleDict:
        m = self.cfg.model
        return nn.ModuleDict({
            ENC: Encoder(m), GEN: Generator(m, unet=self.cfg.use_unet),
            DIS_S: Discriminator(m), DIS_T: Discriminator(m),
        })

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
        gen_params = self._side_params(nets, self.generator_side_keys)
        dis_params = self._side_params(nets, self.discriminator_side_keys)
        zero = torch.zeros((), device=self.device)
        return GanTrainState(
            nets=nets,
            gen_opt=build_optimizer(cfg.opt, gen_params),
            # D updates n_critic-1 times per global step; its schedule is
            # stretched so decayed rates track the global step.
            dis_opt=build_optimizer(self.dis_opt_cfg, dis_params,
                                    updates_per_step=max(1, cfg.n_critic - 1)),
            gdrop_strength=zero.clone(), gen_loss_ema=zero.clone(),
            step=step, critic_step=critic_step,
            gen_ema_params=({k: p.detach().clone() for k, p in gen_params.items()}
                            if cfg.moving_average_decay else None),
        )

    @staticmethod
    def _side_params(nets: nn.ModuleDict, keys) -> dict[str, nn.Parameter]:
        return {f"{k}.{n}": p for k in keys for n, p in nets[k].named_parameters()}

    def translate(self, state: GanTrainState, images: torch.Tensor, direction: str = "s2t",
                  style: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NHWC images of one domain -> the other (``direction`` s2t or
        t2s), the counterpart of the JAX method: eval-mode (moving)
        statistics, the fade-in alpha of ``state.step``, and the
        Polyak-averaged parameters when they are kept. The runner's sample
        dumps call it; the module-level ``translate`` serves a stage."""
        if style is not None:
            raise NotImplementedError("use_style_embedding is not ported to twingan_tpu_torch yet")
        enc, gen = state.nets[ENC], state.nets[GEN]
        modes = enc.training, gen.training
        enc.eval()
        gen.eval()
        try:
            if state.gen_ema_params is not None:
                enc, gen = (self._with_params(net, name, state.gen_ema_params)
                            for net, name in ((enc, ENC), (gen, GEN)))
            return translate(self.cfg, enc, gen, images.to(self.device, torch.float32),
                             direction, step=state.step)
        finally:
            state.nets[ENC].train(modes[0])
            state.nets[GEN].train(modes[1])

    @staticmethod
    def _with_params(net: nn.Module, name: str, params: Mapping[str, torch.Tensor]):
        """``net`` called with the entries of ``params`` under ``name.``."""
        own = {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + ".")}
        return lambda *args, **kw: functional_call(net, own, args, kw)

    def translator_state_dict(self, state: GanTrainState) -> dict[str, torch.Tensor]:
        """The encoder and generator as ``TwinGANTranslator.state_dict()``
        (the Polyak-averaged parameters when they are kept), for
        ``runner.checkpoint.save_stage`` and ``ImageInferer``."""
        sd = {k: v for k, v in state.nets.state_dict().items()
              if k.split(".", 1)[0] in self.generator_side_keys}
        if state.gen_ema_params is not None:
            sd.update(state.gen_ema_params)
        return sd

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _forward(self, nets: nn.ModuleDict, sources: torch.Tensor, targets: torch.Tensor,
                 alpha: float, clip: Optional[dict], update: bool,
                 light: bool = False) -> dict[str, Any]:
        """The four generator passes (and, unless ``light``, the prime
        re-encodes). Output names carry the OUTPUT domain."""
        cfg = self.cfg
        enc, gen = nets[ENC], nets[GEN]

        def gen_apply(code, domain, skips):
            return gen(code, alpha=alpha, domain=domain, renorm_clip=clip,
                       unet_skips=skips if cfg.use_unet else None, update=update)

        def enc_apply(x, domain, update):
            return enc(x, alpha=alpha, domain=domain, update=update, renorm_clip=clip)

        enc_s, skips_s = enc_apply(sources, DOMAIN_S, update)
        enc_t, skips_t = enc_apply(targets, DOMAIN_T, update)
        if cfg.fuse:
            cat = EncoderSkips.cat if cfg.use_unet else (lambda a, b: None)
            s_prime, s_cycle = gen_apply(torch.cat([enc_t, enc_s]), DOMAIN_S,
                                         cat(skips_t, skips_s)).chunk(2)
            t_prime, t_cycle = gen_apply(torch.cat([enc_s, enc_t]), DOMAIN_T,
                                         cat(skips_s, skips_t)).chunk(2)
        else:
            s_prime = gen_apply(enc_t, DOMAIN_S, skips_t)
            s_cycle = gen_apply(enc_s, DOMAIN_S, skips_s)
            t_prime = gen_apply(enc_s, DOMAIN_T, skips_s)
            t_cycle = gen_apply(enc_t, DOMAIN_T, skips_t)
        outs = dict(sources=sources, targets=targets, enc_s=enc_s, enc_t=enc_t,
                    s_prime=s_prime, s_cycle=s_cycle, t_prime=t_prime, t_cycle=t_cycle)
        if not light:
            outs["enc_t_prime"] = enc_apply(t_prime, DOMAIN_T, False)[0]
            outs["enc_s_prime"] = enc_apply(s_prime, DOMAIN_S, False)[0]
        return outs

    def _need_cycle(self) -> bool:
        return self.cfg.model.resolution >= 64 and self.cfg.do_l_cyc_gan

    # ------------------------------------------------------------------ #
    # Losses
    # ------------------------------------------------------------------ #
    def _generator_losses(self, outs, preds) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        losses: dict[str, torch.Tensor] = {}
        for domain, opposite in (("s", "t"), ("t", "s")):
            original = outs["sources" if domain == "s" else "targets"]
            losses[f"l_cyc_{domain}"] = l1_loss(original, outs[f"{domain}_cycle"], cfg.l_cyc_weight)
            if self._need_cycle():
                losses[f"generator_fool_loss_cycle_{domain}"] = generator_gan_loss(
                    cfg.loss, preds[f"dis_{domain}_cycle"])
            losses[f"generator_fool_loss_prime_{domain}"] = generator_gan_loss(
                cfg.loss, preds[f"dis_{domain}_prime"])
            if cfg.l_content_weight:
                losses[f"l_{domain}_content"] = l1_loss(
                    outs[f"enc_{domain}"], outs[f"enc_{opposite}_prime"], cfg.l_content_weight)
        return losses

    # ------------------------------------------------------------------ #
    # Train steps
    # ------------------------------------------------------------------ #
    def _images(self, batch: Mapping[str, torch.Tensor], alpha: float):
        return tuple(self.growing_image(batch[k].to(self.device, torch.float32), alpha)
                     for k in ("source", "target"))

    def g_step(self, state: GanTrainState, batch: Mapping[str, torch.Tensor], rng: int = 0):
        """One generator-side update. ``batch``: NHWC "source" and "target"
        images in [0, 1]. Returns (state, metrics); the state is updated in
        place."""
        cfg = self.cfg
        nets = state.nets
        alpha = self._alpha(state.step)
        sources, targets = self._images(batch, alpha)
        outs = self._forward(nets, sources, targets, alpha, self._renorm_clip(state.step),
                             update=True)
        kinds = ("prime", "cycle") if self._need_cycle() else ("prime",)
        preds = {}
        for domain, dis_name in (("s", DIS_S), ("t", DIS_T)):
            dis = nets[dis_name]
            if cfg.fuse:
                pred = dis(torch.cat([outs[f"{domain}_{k}"] for k in kinds]), alpha=alpha,
                           stddev_groups=len(kinds))
                preds.update({f"dis_{domain}_{k}": p for k, p in zip(kinds, pred.chunk(len(kinds)))})
            else:
                for k in kinds:
                    preds[f"dis_{domain}_{k}"] = dis(outs[f"{domain}_{k}"], alpha=alpha)
        losses = self._generator_losses(outs, preds)
        total = sum(losses.values())
        grads = self._grads(total, state.gen_opt.params)
        grad_norm = global_norm(grads)
        state.gen_opt.step(grads)
        state.gen_loss_ema, strength = update_gdrop_state(
            state.gen_loss_ema, total, state.step, cfg.gdrop_coef, cfg.gdrop_lim, cfg.gdrop_exp)
        if cfg.use_gdrop:
            state.gdrop_strength = strength
        if cfg.moving_average_decay:
            polyak_update(state.gen_ema_params,
                          dict(zip(state.gen_opt.names, state.gen_opt.params)),
                          cfg.moving_average_decay)
        state.step += 1
        state.critic_step += 1
        metrics = {"generator_loss": total.detach(), "alpha": alpha,
                   "gdrop_strength": state.gdrop_strength, "generator_grad_norm": grad_norm,
                   **{k: v.detach() for k, v in losses.items()}}
        return state, metrics

    def d_step(self, state: GanTrainState, batch: Mapping[str, torch.Tensor], rng: int = 0,
               gp_noise: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None):
        """One discriminator-side update. ``gp_noise`` injects the gradient
        penalty's random numbers per domain, ``{"s": {"alpha": [B,1,1,1],
        "noise": images' shape}, "t": {...}}``; otherwise they are drawn
        from ``step_generator(rng, critic_step)``."""
        cfg = self.cfg
        nets = state.nets
        alpha = self._alpha(state.step)
        sources, targets = self._images(batch, alpha)
        with torch.no_grad():
            outs = self._forward(nets, sources, targets, alpha, self._renorm_clip(state.step),
                                 update=False, light=True)
        generator = None if gp_noise is not None else step_generator(
            rng, state.critic_step, self.device)
        need_cycle = self._need_cycle()
        losses: dict[str, torch.Tensor] = {}
        for domain, dis_name, real in (("s", DIS_S, sources), ("t", DIS_T, targets)):
            dis = nets[dis_name]
            fakes = [outs[f"{domain}_prime"]] + ([outs[f"{domain}_cycle"]] if need_cycle else [])
            if cfg.fuse:
                preds = dis(torch.cat([real, *fakes]), alpha=alpha,
                            stddev_groups=1 + len(fakes)).chunk(1 + len(fakes))
            else:
                preds = [dis(x, alpha=alpha) for x in (real, *fakes)]
            for name, val in discriminator_gan_loss(cfg.loss, preds[1], preds[0]).items():
                losses[f"{name}_prime_{domain}"] = val
            if need_cycle:
                # Only the real/fake terms for the cycle.
                cyc = discriminator_gan_loss(cfg.loss, preds[2], preds[0])
                for name in ("discriminator_loss", "discriminator_fake_loss",
                             "discriminator_real_loss"):
                    if name in cyc:
                        losses[f"{name}_cycle_{domain}"] = cyc[name]
            noise = (gp_noise or {}).get(domain, {})
            losses[f"gradient_penalty_{domain}"] = gradient_penalty(
                cfg.loss, lambda x, dis=dis: dis(x, alpha=alpha, attention="plain"),
                real, fakes[0], alpha=noise.get("alpha"), noise=noise.get("noise"),
                generator=generator)
        total = sum(losses.values())
        grads = self._grads(total, state.dis_opt.params)
        for dis_name in self.discriminator_side_keys:
            advance_spectral_norm(nets[dis_name])
        grad_norm = global_norm(grads)
        state.dis_opt.step(grads)
        state.critic_step += 1
        metrics = {"discriminator_loss": total.detach(), "discriminator_grad_norm": grad_norm,
                   **{k: v.detach() for k, v in losses.items()}}
        return state, metrics
