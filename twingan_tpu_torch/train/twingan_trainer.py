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
- the style embedding (``use_style_embedding``): ``encoder_style`` (a
  ``StyleEncoder``) encodes each domain's images in every step (updating
  in the G step, after the content encoder), the prime passes take a
  random N(0, 1) style and the cycle passes each domain's own (one
  concatenated style per fused pass, as the JAX step concatenates
  (random_style, style)), the generator's norms are conditional on it,
  and the G step adds ``l_{s,t}_style``, the L1 distance of the random
  style to the primes' re-encoded styles, weighted by ``l_content_weight``;
- encoder distillation (``do_encoder_distillation``): the heads
  ``distill_s``/``distill_t`` (``EncoderClassifier``, one norm bank each)
  on the content codes of the sources, the targets and the two primes'
  re-encodes, updating in the G step, from ``distillation_start_hw`` on;
  their cosine losses against the batch's ``source_embedding``/
  ``target_embedding`` where the batch has them;
- gdrop (``use_gdrop``): every discriminator pass multiplies its conv
  inputs by gdrop noise of the state's strength, one draw per pass (per
  fused pass: one for the concatenated batch, as the JAX step draws it);
- remat (``remat``): every network pass through ``base.remat_call``.

Random numbers: a step draws them from ``step_generator(rng,
critic_step)``, in this order: the random style, then each
discriminator pass's gdrop noise just before the pass, then (D step) the
penalty's alpha and noise inside its domain's penalty. The JAX step
folds its key per use (``fold_in(k_fwd, 7)`` for the style, ``fold_in(
k_gdrop, i)`` per pass), so the port's numbers are its own; the steps
take them injected (``random_style``, ``gdrop_noise``, ``gp_noise``)
for parity.
Metric names are the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from twingan_tpu_torch import parallel
from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.models.layers import advance_spectral_norm, reset_parameters
from twingan_tpu_torch.models.pggan import (
    Discriminator,
    Encoder,
    EncoderClassifier,
    EncoderSkips,
    Generator,
    StyleEncoder,
)
from twingan_tpu_torch.train.base import (
    BaseGanTrainer,
    fade_alpha,
    require_trainable,
    resolve_device,
    step_generator,
)
from twingan_tpu_torch.train.losses import (
    GanLossConfig,
    cosine_distance_loss,
    discriminator_gan_loss,
    generator_gan_loss,
    gradient_penalty,
    l1_loss,
)
from twingan_tpu_torch.train.optimizers import OptimizerConfig, build_optimizer, global_norm
from twingan_tpu_torch.train.state import GanTrainState, polyak_update, update_gdrop_state

ENC = "encoder_content"
ENC_STYLE = "encoder_style"
GEN = "generator"
DIS_S = "discriminator_s"
DIS_T = "discriminator_t"
DISTILL_S = "distill_s"
DISTILL_T = "distill_t"

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
    """The content encoder and the generator of a TwinGAN stage, and its
    style encoder when the stage was trained with the style embedding."""

    def __init__(self, cfg: TwinGANConfig):
        super().__init__()
        self.cfg = cfg
        self.add_module(ENC, Encoder(cfg.model))
        self.add_module(GEN, Generator(cfg.model, unet=cfg.use_unet,
                                       conditional=cfg.use_style_embedding))
        if cfg.use_style_embedding:
            self.add_module(ENC_STYLE, StyleEncoder(cfg.model, cfg.style_embed_size))


def translate(cfg: TwinGANConfig, enc: Encoder, gen: Generator, images: torch.Tensor,
              direction: str = "s2t", step: int = 0, style: Optional[torch.Tensor] = None,
              enc_style: Optional[StyleEncoder] = None) -> torch.Tensor:
    """Source-domain NHWC images in [0,1] -> target-domain images (or the
    reverse for ``direction='t2s'``), as ``TwinGANTrainer.translate``. A
    stage trained with the style embedding takes ``style`` [B,
    style_embed_size], or computes it from the images with ``enc_style``."""
    if direction not in ("s2t", "t2s"):
        raise ValueError(f"unknown direction {direction!r}")
    src_domain = DOMAIN_S if direction == "s2t" else DOMAIN_T
    out_domain = DOMAIN_T if direction == "s2t" else DOMAIN_S
    alpha = fade_alpha(cfg, step)
    with torch.inference_mode():
        code, skips = enc(images, alpha=alpha, domain=src_domain)
        if cfg.use_style_embedding and style is None:
            if enc_style is None:
                raise ValueError("a stage trained with the style embedding translates with "
                                 "a style or its style encoder")
            style = enc_style(images, alpha=alpha, domain=src_domain)
        if style is not None:
            style = style.to(images.device)
        return gen(code, alpha=alpha, domain=out_domain, style=style,
                   unet_skips=skips if cfg.use_unet else None)


class TwinGANTrainer(BaseGanTrainer):
    """One TwinGAN stage's training: networks ``encoder_content``,
    ``generator``, ``discriminator_s`` and ``discriminator_t`` (and
    ``encoder_style``, ``distill_s``/``distill_t`` with their options), one
    optimizer per side. Runs on the CUDA card unless ``device="cpu"``."""

    discriminator_side_keys = (DIS_S, DIS_T)

    def __init__(self, cfg: TwinGANConfig, device: Optional[str | torch.device] = None):
        require_trainable(cfg)
        self.distill_dims = {}
        if cfg.do_encoder_distillation:
            s_dim = cfg.source_embed_dim or cfg.target_embed_dim
            t_dim = cfg.target_embed_dim or cfg.source_embed_dim
            if not (s_dim and t_dim):
                raise ValueError("do_encoder_distillation requires source_embed_dim or "
                                 "target_embed_dim")
            self.distill_dims = {DISTILL_S: s_dim, DISTILL_T: t_dim}
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator_side_keys = ((ENC, GEN) + ((ENC_STYLE,) if cfg.use_style_embedding
                                                  else ()) + tuple(self.distill_dims))
        self.dis_opt_cfg = (cfg.opt.replace(learning_rate=cfg.discriminator_learning_rate)
                            if cfg.use_ttur else cfg.opt)

    def build_nets(self) -> nn.ModuleDict:
        cfg = self.cfg
        m = cfg.model
        nets = nn.ModuleDict({
            ENC: Encoder(m), GEN: Generator(m, unet=cfg.use_unet,
                                            conditional=cfg.use_style_embedding),
            DIS_S: Discriminator(m, do_gdrop=cfg.use_gdrop),
            DIS_T: Discriminator(m, do_gdrop=cfg.use_gdrop),
        })
        if cfg.use_style_embedding:
            nets[ENC_STYLE] = StyleEncoder(m, cfg.style_embed_size)
        # One head per domain, each run on bank 0: a second bank would be
        # built (and checkpointed) for nothing, as in the JAX trainer.
        for name, dim in self.distill_dims.items():
            nets[name] = EncoderClassifier(m.replace(num_domains=1), dim)
        return nets

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

    @property
    def translator_keys(self) -> tuple:
        """The networks a translation runs: ``TwinGANTranslator``'s."""
        return (ENC, GEN) + ((ENC_STYLE,) if self.cfg.use_style_embedding else ())

    def translate(self, state: GanTrainState, images: torch.Tensor, direction: str = "s2t",
                  style: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NHWC images of one domain -> the other (``direction`` s2t or
        t2s), the counterpart of the JAX method: eval-mode (moving)
        statistics, the fade-in alpha of ``state.step``, and the
        Polyak-averaged parameters when they are kept. With the style
        embedding, ``style`` [B, style_embed_size] or, when None, the
        style encoder's of the images. The runner's sample dumps call it;
        the module-level ``translate`` serves a stage."""
        keys = self.translator_keys
        modes = [state.nets[k].training for k in keys]
        nets = {}
        for k in keys:
            state.nets[k].eval()
            nets[k] = state.nets[k]
            if state.gen_ema_params is not None:
                nets[k] = self._with_params(state.nets[k], k, state.gen_ema_params)
        try:
            return translate(self.cfg, nets[ENC], nets[GEN],
                             images.to(self.device, torch.float32), direction,
                             step=state.step, style=style, enc_style=nets.get(ENC_STYLE))
        finally:
            for k, mode in zip(keys, modes):
                state.nets[k].train(mode)

    @staticmethod
    def _with_params(net: nn.Module, name: str, params: Mapping[str, torch.Tensor]):
        """``net`` called with the entries of ``params`` under ``name.``."""
        own = {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + ".")}
        return lambda *args, **kw: functional_call(net, own, args, kw)

    def translator_state_dict(self, state: GanTrainState) -> dict[str, torch.Tensor]:
        """The translation networks as ``TwinGANTranslator.state_dict()``
        (the Polyak-averaged parameters when they are kept), for
        ``runner.checkpoint.save_stage`` and ``ImageInferer``."""
        keys = self.translator_keys
        sd = {k: v for k, v in state.nets.state_dict().items() if k.split(".", 1)[0] in keys}
        if state.gen_ema_params is not None:
            sd.update({k: v for k, v in state.gen_ema_params.items()
                       if k.split(".", 1)[0] in keys})
        return sd

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _distill_on(self) -> bool:
        cfg = self.cfg
        return cfg.do_encoder_distillation and cfg.model.resolution >= cfg.distillation_start_hw

    def _forward(self, nets: nn.ModuleDict, sources: torch.Tensor, targets: torch.Tensor,
                 alpha: float, clip: Optional[dict], update: bool, light: bool = False,
                 random_style: Optional[torch.Tensor] = None) -> dict[str, Any]:
        """The four generator passes (and, unless ``light``, the prime
        re-encodes, their styles and the distillation heads). Output names
        carry the OUTPUT domain."""
        cfg = self.cfg
        enc, gen = nets[ENC], nets[GEN]
        apply = self._apply

        def gen_apply(code, domain, style, skips):
            return apply(gen, code, alpha=alpha, domain=domain, renorm_clip=clip, style=style,
                         unet_skips=skips if cfg.use_unet else None, update=update)

        def enc_apply(x, domain, update):
            return apply(enc, x, alpha=alpha, domain=domain, update=update, renorm_clip=clip)

        def style_apply(x, domain, update):
            if not cfg.use_style_embedding:
                return None
            return apply(nets[ENC_STYLE], x, alpha=alpha, domain=domain, update=update,
                         renorm_clip=clip)

        enc_s, skips_s = enc_apply(sources, DOMAIN_S, update)
        enc_t, skips_t = enc_apply(targets, DOMAIN_T, update)
        style_s = style_apply(sources, DOMAIN_S, update)
        style_t = style_apply(targets, DOMAIN_T, update)
        if style_s is not None:
            random_style = random_style.to(style_s.dtype)
        if cfg.fuse:
            cat = EncoderSkips.cat if cfg.use_unet else (lambda a, b: None)
            cat_style = (lambda a, b: None) if style_s is None else (
                lambda a, b: torch.cat([a, b]))
            s_prime, s_cycle = gen_apply(torch.cat([enc_t, enc_s]), DOMAIN_S,
                                         cat_style(random_style, style_s),
                                         cat(skips_t, skips_s)).chunk(2)
            t_prime, t_cycle = gen_apply(torch.cat([enc_s, enc_t]), DOMAIN_T,
                                         cat_style(random_style, style_t),
                                         cat(skips_s, skips_t)).chunk(2)
        else:
            s_prime = gen_apply(enc_t, DOMAIN_S, random_style, skips_t)
            s_cycle = gen_apply(enc_s, DOMAIN_S, style_s, skips_s)
            t_prime = gen_apply(enc_s, DOMAIN_T, random_style, skips_s)
            t_cycle = gen_apply(enc_t, DOMAIN_T, style_t, skips_t)
        outs = dict(sources=sources, targets=targets, enc_s=enc_s, enc_t=enc_t,
                    s_prime=s_prime, s_cycle=s_cycle, t_prime=t_prime, t_cycle=t_cycle,
                    style_s=style_s, style_t=style_t, random_style=random_style)
        if light:
            return outs
        outs["enc_t_prime"] = enc_apply(t_prime, DOMAIN_T, False)[0]
        outs["enc_s_prime"] = enc_apply(s_prime, DOMAIN_S, False)[0]
        outs["style_s_prime"] = style_apply(s_prime, DOMAIN_S, False)
        outs["style_t_prime"] = style_apply(t_prime, DOMAIN_T, False)
        if self._distill_on():
            def distill_apply(name, code):
                return apply(nets[name], code, update=update, renorm_clip=clip)

            outs["distill_source"] = distill_apply(DISTILL_S, enc_s)
            outs["distill_target"] = distill_apply(DISTILL_T, enc_t)
            outs["distill_s_prime"] = distill_apply(DISTILL_S, outs["enc_s_prime"])
            outs["distill_t_prime"] = distill_apply(DISTILL_T, outs["enc_t_prime"])
        return outs

    def _need_cycle(self) -> bool:
        return self.cfg.model.resolution >= 64 and self.cfg.do_l_cyc_gan

    # ------------------------------------------------------------------ #
    # Losses
    # ------------------------------------------------------------------ #
    def _generator_losses(self, outs, preds, batch) -> dict[str, torch.Tensor]:
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
                if cfg.use_style_embedding:
                    losses[f"l_{domain}_style"] = l1_loss(
                        outs["random_style"], outs[f"style_{domain}_prime"],
                        cfg.l_content_weight)
            full = "source" if domain == "s" else "target"
            expected = batch.get(f"{full}_embedding")
            if self._distill_on() and expected is not None:
                expected = expected.to(self.device)
                losses[f"l_{full}_distillation"] = cosine_distance_loss(
                    expected, outs[f"distill_{full}"], cfg.distillation_weight)
                losses[f"l_{opposite}_prime_distillation"] = cosine_distance_loss(
                    expected, outs[f"distill_{opposite}_prime"], cfg.distillation_weight)
        return losses

    # ------------------------------------------------------------------ #
    # Train steps
    # ------------------------------------------------------------------ #
    def _images(self, batch: Mapping[str, torch.Tensor], alpha: float):
        return tuple(self.growing_image(batch[k].to(self.device, torch.float32), alpha)
                     for k in ("source", "target"))

    def _random_style(self, batch_size: int, generator: torch.Generator,
                      injected: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The prime passes' N(0, 1) style [B, style_embed_size], drawn
        before the passes (or injected); None without the style embedding."""
        if not self.cfg.use_style_embedding:
            return None
        if injected is not None:
            return parallel.local_rows(injected).to(self.device, torch.float32)
        return parallel.draw_rows(torch.randn, (batch_size, self.cfg.style_embed_size),
                                  generator=generator, device=self.device)

    def g_step(self, state: GanTrainState, batch: Mapping[str, torch.Tensor], rng: int = 0,
               random_style: Optional[torch.Tensor] = None,
               gdrop_noise: Optional[Mapping[str, list]] = None):
        """One generator-side update. ``batch``: NHWC "source" and "target"
        images in [0, 1] (and "source_embedding"/"target_embedding" for
        distillation). ``random_style`` and ``gdrop_noise`` inject the
        step's draws: the style [B, style_embed_size], and per
        discriminator pass ("s_prime", "s_cycle", "t_prime", "t_cycle"; "s"
        and "t" when fused) the list ``Discriminator.gdrop_shapes`` lays
        out. Returns (state, metrics); the state is updated in place."""
        cfg = self.cfg
        nets = state.nets
        alpha = self._alpha(state.step)
        sources, targets = self._images(batch, alpha)
        generator = step_generator(rng, state.critic_step, self.device)
        style = self._random_style(sources.shape[0], generator, random_style)
        outs = self._forward(nets, sources, targets, alpha, self._renorm_clip(state.step),
                             update=True, random_style=style)
        kinds = ("prime", "cycle") if self._need_cycle() else ("prime",)
        preds = {}
        for domain, dis_name in (("s", DIS_S), ("t", DIS_T)):
            dis = nets[dis_name]
            kw = dict(alpha=alpha, gdrop_strength=state.gdrop_strength)
            if cfg.fuse:
                x = torch.cat([outs[f"{domain}_{k}"] for k in kinds])
                noise = self._gdrop_noise(dis, x.shape[0], generator, gdrop_noise, domain,
                                          parts=len(kinds))
                pred = self._apply(dis, x, stddev_groups=len(kinds), gdrop_noise=noise, **kw)
                preds.update({f"dis_{domain}_{k}": p for k, p in zip(kinds, pred.chunk(len(kinds)))})
            else:
                for k in kinds:
                    x = outs[f"{domain}_{k}"]
                    noise = self._gdrop_noise(dis, x.shape[0], generator, gdrop_noise,
                                              f"{domain}_{k}")
                    preds[f"dis_{domain}_{k}"] = self._apply(dis, x, gdrop_noise=noise, **kw)
        losses = self._generator_losses(outs, preds, batch)
        total = sum(losses.values())
        grads = self._grads(total, state.gen_opt.params)
        losses = self._global_metrics({"generator_loss": total, **losses})
        total = losses.pop("generator_loss")
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
               gp_noise: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
               random_style: Optional[torch.Tensor] = None,
               gdrop_noise: Optional[Mapping[str, list]] = None):
        """One discriminator-side update. ``gp_noise`` injects the gradient
        penalty's random numbers per domain, ``{"s": {"alpha": [B,1,1,1],
        "noise": images' shape}, "t": {...}}``; ``random_style`` the style
        of the generator passes, and ``gdrop_noise`` each discriminator
        pass's gdrop draws ("s_real", "s_prime", "s_cycle", "s_gp", ...;
        "s", "s_gp", ... when fused). Otherwise they are drawn from
        ``step_generator(rng, critic_step)``."""
        cfg = self.cfg
        nets = state.nets
        alpha = self._alpha(state.step)
        sources, targets = self._images(batch, alpha)
        generator = step_generator(rng, state.critic_step, self.device)
        style = self._random_style(sources.shape[0], generator, random_style)
        with torch.no_grad():
            outs = self._forward(nets, sources, targets, alpha, self._renorm_clip(state.step),
                                 update=False, light=True, random_style=style)
        need_cycle = self._need_cycle()
        losses: dict[str, torch.Tensor] = {}
        for domain, dis_name, real in (("s", DIS_S, sources), ("t", DIS_T, targets)):
            dis = nets[dis_name]
            kw = dict(alpha=alpha, gdrop_strength=state.gdrop_strength)
            fakes = [outs[f"{domain}_prime"]] + ([outs[f"{domain}_cycle"]] if need_cycle else [])

            def noise(key: str, parts: int = 1):
                return self._gdrop_noise(dis, parts * real.shape[0], generator, gdrop_noise,
                                         key, parts)

            if cfg.fuse:
                x = torch.cat([real, *fakes])
                preds = self._apply(dis, x, stddev_groups=1 + len(fakes),
                                    gdrop_noise=noise(domain, 1 + len(fakes)),
                                    **kw).chunk(1 + len(fakes))
            else:
                preds = [self._apply(dis, x, gdrop_noise=noise(f"{domain}_{kind}"), **kw)
                         for kind, x in zip(("real", "prime", "cycle"), (real, *fakes))]
            for name, val in discriminator_gan_loss(cfg.loss, preds[1], preds[0]).items():
                losses[f"{name}_prime_{domain}"] = val
            if need_cycle:
                # Only the real/fake terms for the cycle.
                cyc = discriminator_gan_loss(cfg.loss, preds[2], preds[0])
                for name in ("discriminator_loss", "discriminator_fake_loss",
                             "discriminator_real_loss"):
                    if name in cyc:
                        losses[f"{name}_cycle_{domain}"] = cyc[name]
            gp_gdrop = noise(f"{domain}_gp")
            gp = (gp_noise or {}).get(domain, {})
            losses[f"gradient_penalty_{domain}"] = gradient_penalty(
                cfg.loss, lambda x, dis=dis, n=gp_gdrop: self._apply(
                    dis, x, attention="plain", gdrop_noise=n, **kw),
                real, fakes[0], alpha=parallel.local_rows(gp.get("alpha")),
                noise=parallel.local_rows(gp.get("noise")), generator=generator)
        total = sum(losses.values())
        grads = self._grads(total, state.dis_opt.params)
        for dis_name in self.discriminator_side_keys:
            advance_spectral_norm(nets[dis_name])
        grad_norm = global_norm(grads)
        state.dis_opt.step(grads)
        state.critic_step += 1
        metrics = self._global_metrics({"discriminator_loss": total.detach(),
                                        **{k: v.detach() for k, v in losses.items()}})
        metrics["discriminator_grad_norm"] = grad_norm
        return state, metrics
