"""Grad-CAM class-activation heatmaps.

Counterpart of ``twingan_tpu/models/grad_cam.py``: the gradient of the
target logit with respect to a conv end point, averaged over space into
one weight per channel; the relu of the weighted sum of the activations,
normalized per image and resized to the input with bilinear half-pixel
sampling; and the overlay of the heatmap on the image.

As in the JAX function, the gradient is taken at a probe: a zero tensor
added at the end point (``probes={layer: None}`` makes the zoo create it,
requiring a gradient), whose gradient at 0 is the gradient with respect to
the activations. One forward pass gives the logits, the activations and,
through ``torch.autograd.grad``, the weights.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from twingan_tpu_torch.ops import basic


def grad_cam(apply_fn: Callable[..., tuple[torch.Tensor, dict]], images: torch.Tensor,
             layer_name: str, class_index=None) -> torch.Tensor:
    """[B, H, W] heatmaps in [0, 1] at the input resolution of NHWC
    ``images``. ``apply_fn(images, probes=...)`` -> (logits, end_points)
    must expose ``layer_name`` as a [B, h, w, c] end point; the score is
    the logit of ``class_index`` (an int or [B]), or of each image's top
    class."""
    probes = {layer_name: None}
    with torch.enable_grad():
        logits, eps = apply_fn(images, probes=probes)
        acts = eps[layer_name]
        if acts.dim() != 4:
            raise ValueError(f"Grad-CAM needs a spatial [B,h,w,c] end point; {layer_name!r} "
                             f"has shape {tuple(acts.shape)}. Pick a conv end point.")
        if class_index is None:
            idx = torch.argmax(logits, dim=-1)
        else:
            idx = torch.as_tensor(class_index, device=logits.device).long()
            if idx.dim() == 0:
                idx = idx.expand(images.shape[0])
        score = torch.gather(logits, 1, idx[:, None]).sum()
        grads, = torch.autograd.grad(score, probes[layer_name])
    weights = torch.mean(grads, dim=(1, 2), keepdim=True)  # [B,1,1,C]
    cam = F.relu(torch.sum(weights * acts.detach(), dim=-1))  # [B,h,w]
    cam = cam / (torch.amax(cam, dim=(1, 2), keepdim=True) + 1e-8)
    h, w = images.shape[1], images.shape[2]
    if cam.shape[1] <= h and cam.shape[2] <= w:
        return F.interpolate(cam[:, None], size=(h, w), mode="bilinear",
                             align_corners=False)[:, 0]
    return basic.resize_bilinear(cam[..., None], h, w)[..., 0]


def impose_mask_on_image(image: torch.Tensor, mask: torch.Tensor,
                         alpha: float = 0.5) -> torch.Tensor:
    """Overlay a [..., H, W] heatmap on a [..., H, W, 3] image: the heat
    blend (red high, blue low), clipped to [0, 1]."""
    heat = torch.stack([mask, torch.zeros_like(mask), 1.0 - mask], dim=-1)
    return torch.clamp((1 - alpha) * image + alpha * heat, 0.0, 1.0)
