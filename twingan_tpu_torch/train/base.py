"""Shared GAN trainer base: the fade-in schedule and the n-critic round.

Counterpart of ``twingan_tpu/train/base.py``. PyTorch runs eagerly, so
``g_step``/``d_step`` are the subclass's methods as they are (the JAX
package jit-compiles them), and ``scan_rounds``, which the JAX package
compiles into one on-device loop, is a Python loop over stacked batches
with the same counter semantics.

The step functions take ``rng``, an integer seed; a step's random numbers
come from ``step_generator(rng, critic_step)``, as the JAX steps fold the
critic counter into their PRNG key.

Data parallelism (``twingan_tpu_torch.parallel``): under a current process
group each process's step runs on its rows of the global batch, its
draws with a batch axis are made at the global batch and sliced
(``parallel.draw_rows``; injected draws are global too), the gradients
and the step's metrics are averaged over the processes (``_grads``,
``_global_metrics``), and the model's batch reductions are collectives.
The processes' states stay equal, as the JAX package's replicated state
on a mesh does.

Remat (``cfg.remat``, the JAX ``apply_model(remat=True)``): each network
pass of a step runs under ``torch.utils.checkpoint`` (``remat_call``), so
the backward recomputes its activations instead of keeping them. The JAX
remat is pure and the port's state is written in place, so the recompute
reads the networks' buffers (moving statistics, renorm EMAs, spectral
``u``) as the first call found them and writes none; the noise a pass
takes (gdrop, the random style, the penalty's draws) is drawn before the
pass and handed to it, so that the recompute sees the same numbers.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from twingan_tpu_torch import parallel
from twingan_tpu_torch.models.config import require_inference_only
from twingan_tpu_torch.ops import basic, norms


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the CUDA card, which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: twingan_tpu_torch runs on the card unless "
                "device='cpu' is passed")
        return torch.device("cuda")
    return torch.device(device)


def fade_alpha(cfg, step: int) -> float:
    """The fade-in alpha at ``step``: 0 on a stable stage, else the linear
    ramp over [grow_start_step, max_steps]."""
    if not cfg.model.is_growing:
        return 0.0
    denom = max(cfg.max_steps - cfg.grow_start_step, 1)
    return float(step - cfg.grow_start_step) / denom


def renorm_clip(cfg, step: int) -> Optional[dict]:
    """Batch renorm's rmax/rmin/dmax at the global ``step`` (which restarts
    at 0 each stage); None unless the model runs batch renorm."""
    if cfg.model.norm_type != "batch_renorm":
        return None
    return norms.renorm_clipping_schedule(step)


def step_generator(rng: int, critic_step: int, device: torch.device) -> torch.Generator:
    """The random stream of one step: seeded from (rng, critic_step)."""
    seed = (int(rng) * 1_000_003 + int(critic_step)) % (2**63)
    return torch.Generator(device=device).manual_seed(seed)


def require_trainable(cfg) -> None:
    """Raise the ``ValueError`` of an inference-only model."""
    require_inference_only(cfg.model, "a trainer")


def remat_call(fn: Callable, modules: Sequence[nn.Module], *args, **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) when autograd records it.
    The recompute reads the buffers of ``modules`` as this call found them
    and leaves them as it finds them: what the first call wrote stays, and
    nothing is written twice."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    buffers = [b for m in modules for b in m.buffers()]
    before = [b.detach().clone() for b in buffers]
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a, **kw)
        after = [b.detach().clone() for b in buffers]
        with torch.no_grad():
            for b, v in zip(buffers, before):
                b.copy_(v)
        try:
            return fn(*a, **kw)
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, after):
                    b.copy_(v)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


class BaseGanTrainer:
    """Subclasses implement ``g_step``/``d_step`` (state, batch, rng) ->
    (state, metrics) and set ``self.cfg`` with model/n_critic/growth
    fields."""

    def _alpha(self, step: int) -> float:
        return fade_alpha(self.cfg, step)

    def _renorm_clip(self, step: int) -> Optional[dict]:
        return renorm_clip(self.cfg, step)

    def _gdrop_noise(self, dis: nn.Module, batch_size: int, generator: torch.Generator,
                     injected: Optional[Mapping[str, list]], key: str,
                     parts: int = 1) -> Optional[list]:
        """A discriminator pass's gdrop noise: ``injected[key]``, or drawn
        now from ``generator``, before the pass (for remat); None without
        gdrop. Under a process group both are of the global batch (``parts``
        of them end to end for a fused pass) and this process takes its
        rows."""
        if not self.cfg.use_gdrop:
            return None
        if injected is not None:
            return [parallel.local_rows(t, parts=parts).to(self.device) for t in injected[key]]
        return [parallel.draw_rows(torch.randn, shape, parts=parts, generator=generator,
                                   device=self.device) for shape in dis.gdrop_shapes(batch_size)]

    def _apply(self, net: nn.Module, *args, **kwargs):
        """One pass of ``net``; under ``cfg.remat`` through ``remat_call``."""
        if self.cfg.remat:
            return remat_call(net, (net,), *args, **kwargs)
        return net(*args, **kwargs)

    def growing_image(self, x: torch.Tensor, alpha: float) -> torch.Tensor:
        """Fade-in blend of NHWC images with their low-res selves."""
        if not self.cfg.model.is_growing:
            return x
        low = basic.upsample_nearest_2x(basic.avg_pool_2x(x))
        return basic.blend(x, low, alpha)

    @staticmethod
    def _grads(total: torch.Tensor, params) -> list[torch.Tensor]:
        """d total / d params, zeros for a parameter the loss does not reach.
        Under a process group each process's ``total`` is its rows' share
        of the loss, and the gradients are averaged over the processes, one
        flat all-reduce: the gradient of the whole batch's loss. The step
        takes them with ``torch.autograd.grad`` (and the penalty's double
        backward), which ``DistributedDataParallel``'s hooks on
        ``.backward()`` would not see."""
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        parallel.all_reduce_mean_(grads, parallel.current_group())
        return grads

    @staticmethod
    def _global_metrics(values: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``values`` (each process's means over its rows) averaged over the
        processes of the current group, one all-reduce, each in its own
        dtype: the means of the whole batch. Unchanged without a group."""
        group = parallel.current_group()
        if group is None:
            return dict(values)
        stacked = torch.stack([v.detach().float() for v in values.values()])
        parallel.all_reduce_mean_([stacked], group)
        return {k: m.to(v.dtype) for (k, v), m in zip(values.items(), stacked.unbind(0))}

    def eval_metrics(self, state, batch, rng: int = 0, **step_kw):
        """The G step's metrics with the caller's state left untouched: the
        step runs on a deep copy of the state (networks, optimizers,
        counters), which is then dropped, as the JAX ``eval_metrics``
        discards the stepped state."""
        _, metrics = self.g_step(copy.deepcopy(state), batch, rng, **step_kw)
        return metrics

    def round_step(self, state, batches, rng: int = 0):
        """One n-critic round: G first, then n_critic-1 D updates."""
        state, metrics = self.g_step(state, batches[0], rng)
        metrics = dict(metrics)
        for i in range(1, self.cfg.n_critic):
            state, d_metrics = self.d_step(state, batches[i], rng)
            metrics.update(d_metrics)
        return state, metrics

    def scan_rounds(self, state, batches: Mapping[str, torch.Tensor], rng: int = 0):
        """Rounds over stacked batches: each leaf is [n_rounds, n_critic,
        batch, ...]. Returns the final state and each metric stacked over
        the rounds."""
        n_rounds = next(iter(batches.values())).shape[0]
        history: dict[str, list] = {}
        for r in range(n_rounds):
            round_batches = [{k: v[r, i] for k, v in batches.items()}
                             for i in range(self.cfg.n_critic)]
            state, metrics = self.round_step(state, round_batches, rng)
            for k, v in metrics.items():
                history.setdefault(k, []).append(torch.as_tensor(v))
        return state, {k: torch.stack(v) for k, v in history.items()}
