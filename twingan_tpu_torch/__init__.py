"""PyTorch port of ``twingan_tpu`` for one NVIDIA Hopper card.

The package mirrors ``twingan_tpu/`` module for module (``models/``,
``ops/``, ``train/``, ``runner/``, ``data/``, ``utils/``, ``infer/``,
``serve/``, ``parallel/``) and keeps its parameter names, so a reader finds each module's
counterpart and a Flax checkpoint bridges 1:1 (``bridge.py``). It imports
``torch`` and never ``jax``, ``flax`` or ``twingan_tpu``.

Slices ported so far: 256 px image translation served through
``infer.translate.ImageInferer`` and ``serve.clients``, and the 256 px
TwinGAN training round (``train.twingan_trainer.TwinGANTrainer``), with
SAGAN self-attention on hand-written CUDA flash-attention kernels, forward
(``csrc/flash_attn_fwd.cu``) and backward (``csrc/flash_attn_bwd.cu``);
256 px PGGAN generation (``train.gan_trainer.GanTrainer``), whose
generator runs its conv-leaky-pixel-norm layers on the hand-written fused
conv kernel (``csrc/fused_conv.cu``) wherever no gradient is needed;
and progressive training, 4 px to 256 px stage by stage with growth
migration and resumable checkpoints (``runner.stage_runner.StageRunner``,
the CLI ``python -m twingan_tpu_torch.runner.pggan_runner``, one process
a device under torchrun); and the serving front door, the HTTP server
with its Haar face detector (``python -m twingan_tpu_torch.serve.server``).
Public functions take NHWC tensors, like the JAX package; modules compute
in NCHW views of the same memory. This file imports nothing, so that the
face detector's worker processes start without torch.
"""
