#!/usr/bin/env python3
"""Drive the PyTorch port (``twingan_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero and no
result line is printed:

1. device   - the card's name, power limit and top SM clock; TF32 off for
              the comparisons.
2. build    - nvcc builds ``csrc/flash_attn_fwd.cu`` (the flash-attention
              forward kernel), ``csrc/flash_attn_bwd.cu`` (its two
              backward kernels, dq and dkv), ``csrc/fused_conv.cu``
              (the fused conv3x3 + bias + leaky + pixel-norm kernel B4;
              each of the four kernels has a tensor-core variant for bf16;
              for fp32, B1 and B3 run on the TF32 tensor cores with each
              product split into three, 3xTF32, and B2 and B4 on the CUDA
              cores) and ``csrc/conv_i8.cu`` (the
              int8 conv Q1 of W8A8 serving) into ctypes libraries, the
              four compiles started together, and prints each kernel's
              registers and spills.
3. kernel   - at each listed shape, the forward kernel against its plain
              PyTorch version on the same inputs (output and logsumexp);
              then the backward kernels: the gradients that
              ``FlashAttention`` returns (forward kernel, delta, dq, dkv)
              against autograd of the plain ``attention_core`` on the same
              f, g, h and output gradient (above N 16384 against a
              reference chunked over query rows, which also checks the
              forward kernel there). Each row names the variant that ran
              (``attention.variant``: bf16 on the tensor cores; fp32 B1
              and B3 on the TF32 tensor cores, 3xTF32, B2 on the CUDA
              cores; past c_bar 64 or C 256 the wide kernels) and fails on
              another, and has the kernels', the plain versions' and SDPA's
              times (CUDA events, median) beside the card's bound for the
              same work. Then B4 against its plain version at the TPU
              script's shape, at every distinct
              layer of the generation configuration (pggan256, batch 12,
              bf16), in fp32, at a ragged 20 x 20 and at the widths
              past 256 channels (512 and 1024), each row naming its
              variant, with cuDNN's conv alone (NCHW, and at its best:
              benchmark mode, channels-last) and the eager chain of the
              grad route beside it.
4. serving  - the serving path at full width: a 256 px TwinGAN (batch
              norm, eq-lr, pixel norm, UNet skips, bf16, SAGAN attention at
              64 px) with seeded random weights is written as a stage dir,
              loaded by ``ImageInferer`` and served to 8 concurrent requests
              per round through ``BatchingLocalClient``; the forward
              kernel's launch count must be 2 (encoder + generator) per
              dispatched batch, all of them its tensor-core variant, and
              one request must agree with the same weights run in fp32 on
              the CPU with the plain attention.
5. http     - the serving front door: the serving phase's stage served by the port's
              HTTP server (``serve/server.py``, built by ``build_service``
              as its command line builds it) on 127.0.0.1 through
              ``BatchingLocalClient`` (batches of 4), the Haar detector in
              2 worker processes, at most 4 faces a request; the faces
              image (``tests/data/real_faces_gallery.png``, 10 faces)
              posted raw, as multipart and as base64 JSON, 8 requests at a
              time, a warm-up round and a timed one. Every answer must
              count the faces the detector finds in-process, every output
              PNG must come back by GET and decode (the combine twice as
              wide as high), each translated face must agree with the same
              crop through the fp32 CPU inferer within serving's limits,
              and B1 must run twice a dispatched batch, all tensor-core.
              One line: latency p50, p90 and max, faces/s, and a
              request's mean time in detection, translation and queued
              writes. Where PIL is present, the ``detect_face`` preview
              is posted too (its label text needs PIL).
6. train    - the training path at full width: ``TwinGANTrainer`` on the
              same configuration (DRAGAN, Adam, n_critic 2, batch 3, seeded
              random weights with every sa_gamma 1). One G step and one D
              step on the card, in fp32 and in bf16, are held against the
              same weights, batch and injected noise in fp32 on the CPU
              with the plain attention (losses, and the cosine similarity
              of each network's gradient and of every attention
              projection's), each step on the fp32 or the bf16 variants of
              the three attention kernels only; then one warm-up and 3
              timed bf16 rounds, whose kernel launches must be what the
              passes of the step imply, on the tensor-core variants; then
              the trained state is written as a stage dir
              and ``ImageInferer`` serves a batch from it. Then the fp32
              phase, the JAX package's default type end to end: the
              serving phase in fp32 (B1 on its 3xTF32 variant only) and one
              warm-up and 3 timed fp32 rounds at batch 3 (B1 and B3 on the
              3xTF32 variants, B2 on the CUDA cores). Neither serving nor
              training may take a B4 route (they run batch norm).
7. generation - the generation path at full width and depth:
              ``GanTrainer`` on pggan256 (256 px, max_channels 256, no
              norm, pixel norm, eq-lr, bf16; batch 12, DRAGAN, Adam,
              n_critic 2) with seeded random weights and biases. One G
              step and one D step on the card, in fp32 and in bf16, held
              against the same weights, batch, z and penalty noise in fp32
              on the CPU at batch 4 (the fp32 D step's B4 launches all
              CUDA-core, the bf16 one's all tensor-core); one warm-up and
              3 timed rounds, 13 B4 launches per D step, all tensor-core,
              and 13 autograd-route steps per G step; ``sample`` of 12
              images from the trained state (13 tensor-core B4 launches)
              against the same state in fp32 on the CPU.
8. runner   - progressive training through the stage runner, the
              training entry point: pggan256 on synthetic data from 4 to
              256 px (13 stages, 48 images a resolution, a checkpoint every
              2 steps, 2 kept), in two calls on one train dir (7 stages,
              then the rest, which skip the first 7 and grow 32 -> 32to64
              from disk), B4's tensor-core launches per stage held to
              rounds x (n_critic - 1) x (1 + 2 log2(res / 4)); the 256
              stage's checkpoint restored on the card and on the CPU, 12
              samples of each held to serving's limits; one fresh 256 px
              stage of 40 rounds (a checkpoint every 20 steps), where the
              first round and the writes are spread. Then the TwinGAN
              slice config from 128 to 256 px (stages 128, 128to256 and 256,
              2 rounds each), B1-B3's tensor-core launches per stage held to
              the passes' count, and a batch served from the final
              ``model.pt``. One line per stage: steps, rounds/s, the
              stage's wall time and its parts, peak memory, launches.
9. data     - a dataset of two domains, A and B, of 512 smooth random
              images each (half 256 x 256, half 320 x 272 so that PAD
              resamples), drawn from the seed and written as PNG (every row
              filter in turn, by the encoder here) in 4 tfrecord shards per
              domain; every image read back through ``TFRecordSource``
              equals its array; the native host library must have loaded;
              decode and host-resize ms per image (4, 32, 256 px), one
              256 px stage's decode-and-resize time and the bytes it puts
              on the card.
10. runner_data - training on that dataset through the stage runner:
              pggan256 from 4 to 256 px on A (the CLI's flags, 48 images a
              resolution, device-resident), the in-training SWD every 3
              steps, so once a stage from 16 px on: B4's launches per stage
              are the runner phase's formula plus one ``sample`` per SWD,
              and every ``swd_in_training_<step>.txt`` must hold finite
              scores; one fresh 256 px stage of 40 rounds (its rounds/s
              beside the synthetic stage's), and the same stage streamed
              by the ``DevicePrefetcher`` for 10 rounds, whose raw batches
              must equal the resident stage's bit for bit; the TwinGAN
              slice config from 128 to 256 px, A as source and B as target,
              B1-B3 launches per stage as in the runner phase.
11. eval    - ``run_eval`` on that TwinGAN run's final stage: ``swd`` on
              2048 images (the chunked path), ``msssim`` on 256, ``loss``
              and ``output`` on 64, each with its attention launches held
              to its translations' and passes' count (2 B1 a translated
              batch); then the SWD (both paths) and MS-SSIM of 128 fixed
              images on the card against the CPU with the same draws.
12. recipe  - the reference's headline TwinGAN recipe (docs/USAGE.md:
              batch renorm, UNet, pixel norm, max_channels 256, DRAGAN
              lambda 0.25, lr 1e-4, the recipe's batch schedule, bf16)
              with SAGAN attention at 64 px: one G and one D step at
              256 px, batch 3, global step 10001 (the schedule's second
              clip), from renorm EMAs drawn from the seed and He-scaled
              kernels, on the card in fp32 and bf16 against fp32 on the
              CPU (TRAIN_LIMITS; the renorm EMAs and moving statistics
              after the step too), the clipped r and d counted; 3 timed
              256 px rounds beside the train phase's batch-norm rate; the
              plan from 4 to 256 px through the training command's
              main() on synthetic data, B1-B3's tensor-core launches per
              stage held to the passes' count (from 32to64 on), every
              stage's renorm EMAs finite and moved from zero, and the 256
              stage served by ``ImageInferer`` within serving's limits of
              the CPU. Then pggan256 with spectral norm (without eq-lr):
              a G and a D step against the CPU with every u held to
              SPECTRAL_U_ATOL, and, with spectral norm in the generator
              too, a 12-image ``sample`` on B4's tensor-core variant (13
              launches, W / sigma folded in) against the CPU.
13. options - the trainer options. The slice config with the style
              embedding (16 wide: the generator's norms conditional),
              distillation (512-wide unit embeddings), gdrop and remat,
              batch 3: a G and a D step at global step 101 with gdrop
              strength 0.05, the random style and every gdrop draw made on
              the CPU and handed to both, on the card in fp32 against fp32
              on the CPU (TRAIN_LIMITS' fp32 row; the style and
              distillation losses among those compared; why not bf16:
              OPTIONS_TWINGAN_LIMITS); 3 timed bf16 rounds
              with remat and 3 without, in this call (rounds/s, peak
              memory), B1-B3's launches held to the passes' count with
              remat's recompute counted (2 forward launches a
              differentiated pass). pggan256 with gdrop and conditional
              labels (51 classes, 32 wide) under rmsprop: a G and a D step
              against the CPU, the optimizer's update held too (cosine), a
              round (13 B4 launches in its D step) and a labelled
              12-image sample within serving's limits (13 B4 launches);
              then one D step each under adagrad, adadelta and ftrl
              against the CPU. Then the training command
              (``pggan_runner.main``, what ``python -m
              twingan_tpu_torch.runner.pggan_runner`` runs) with
              --use_style_embedding --use_gdrop --remat from 128 to 256 px,
              2 rounds a stage, B1-B3 launches per stage held to its
              passes and its sample dump, the style-interpolation grid
              written, and the 256 stage served with a given style within
              serving's limits of the CPU and with its own.
14. classifiers - the classifier zoo (A14), fp32 with TF32 off: every
              network at its reference input size (lenet 28, cifarnet 32,
              alexnet/vgg/illust2vec/resnets/mobilenet/inception v1-v2/
              nasnet_mobile 224, overfeat 231, inception v3/v4/resnet v2
              299, nasnet_large 331; illust2vec's 1539 classes, 1000 the
              others) with seeded weights, at batch 2 on the card against
              the same weights on the CPU (logits within ZOO_RTOL), timed
              at batch 32 (ms, peak memory), one line each; the reference
              tagger through the classifier CLI (``classifier_runner.main``:
              illust2vec, 224 px, 1539 classes, batch 32, rmsprop lr 0.01,
              weight decay 4e-5, synthetic data, 20 steps; steps/s after
              the first, peak memory), its eval, tags and gradcam modes on
              the train dir (trained as 1 step and its resumption), one
              more step from step 1's checkpoint on the card against the
              CPU (loss, cosines of the gradient and of the update) and
              the trained state's Grad-CAM maps against the CPU's; a
              cifarnet FID classifier
              through the CLI with ``artifacts/fid_classifier``'s config
              (12 labels, 32 px, batch 64, adam lr 0.003, 200 steps); then
              ``run_eval --mode=fid`` and ``--mode=inception_score`` on the
              eval phase's TwinGAN stage (256 px, attention at 64 px), 256
              images each, with the random InceptionV3 (``Mixed_5b``, 256
              features) and with that classifier: B1 twice a translated
              batch, all tensor-core, seconds per mode; and the card's
              features and FID of fixed images against the CPU's with the
              same weights (features within FEATURES_MEAN_TOL and
              FEATURES_MAX_TOL of the std, FID within FID_CARD_RTOL).
15. int8    - W8A8 int8 serving (kernel Q1, ``csrc/conv_i8.cu``, on the
              int8 tensor cores) of the serving phase's slice config (256
              px, bf16, batch norm, UNet, attention at 64 px):
              ``ImageInferer(quantize=True)`` behind
              ``BatchingLocalClient``, warmed up past ``CALIB_MIN_IMAGES``
              (each batch calibrated on, then served in int8), then 3
              timed rounds of 8 requests (images/s beside the serving
              phase's bf16 rate), B1 2 and Q1's fused entry ``conv_i8q``
              34 launches a dispatched batch (one a conv of the encoder
              and the generator), its int8 entry ``conv_i8`` none, no B4;
              the kernels and copies the card runs for one frozen int8
              batch of 4 and one bf16 batch (torch.profiler). Both entries
              against their plain versions at every distinct conv of a
              translated batch of 4 (read by hooks), the fused-scale up
              conv (dilation 2) and a ragged Cin: int32 sums and fp32 and
              bf16 outputs bit-equal, ``conv_i8q`` from bf16 and from fp32
              x; each entry's device time, the plain versions', the old
              path's quantize and NHWC copy, both bounds, ``torch._int_mm``
              on the unfolded input, and the registers and spills of the
              instances that ran. The card against the CPU in fp32 with the card's
              scales: every conv given the CPU's input bit-equal, the
              first layer's codes equal and the second's within
              INT8_SECOND_FLIP_TOL, the output within INT8_CPU_* (the
              share of flipped codes at every layer printed); int8
              against bf16 on the card (L1, PSNR). Then ``export_torch``
              of the bf16 and the calibrated int8 inferer, ``load_torch``
              and a batch each: B1 2 and ``conv_i8q`` 34 (int8) launches
              through the custom ops, outputs equal to the eager ones bit for
              bit, export and load seconds.
16. parallel - the multi-device training path over a real NCCL process
              group of one process (tcp on a free local port, rank 0; its
              failure fails the run): the context-parallel attention core
              called directly at the serving and training shapes (bf16),
              forward and backward through the all-to-all and all-gather,
              bit-equal to the local ``self_attention`` with one B1, B2 and
              B3 launch each, and its per-process core at two processes'
              split of the keys (two launches of each) against the plain
              version; one round of the TwinGAN slice config (256 px, batch
              3) with ``attention_context_parallel`` and
              ``sync_batch_norm_axis="data"`` (its attention on the local
              path, which a group of one takes) and one pggan256 round (batch
              12), each under the group bit-equal to the same round without
              it (every parameter, statistic, optimizer slot and metric),
              B1-B3 launches as ``expected_launches`` counts them and 13 B4
              launches a D step; a ``StageRunner`` plan under the group
              (pggan256 4 -> 16 px, ``num_devices=1``, two calls on one
              train dir: the coordinator writes every stage, the second
              call skips the first three and grows the rest from disk),
              B4's launches per stage. One line per check, and a summary
              line (NCCL version, world size, each check's largest
              difference, the path's launches, seconds).
17. kernels - one line listing each kernel of the paths, with its
              variants, its numbers at the main shape in bf16 and (B1-B3)
              in fp32.
Then the card as ``nvidia-smi`` names it, and the last line
``{"ok": true, "device": {...}}``.

It needs one CUDA card and the repository around it; without either it
exits non-zero. A watchdog ends it (non-zero) after 15 minutes. It writes
only under the system's temporary directory, and removes what it wrote.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import statistics
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 900
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
# Each kernel of the paths: its source and the TPU kernel it replaces.
KERNELS = {
    "flash_attn_fwd": ("twingan_tpu_torch/csrc/flash_attn_fwd.cu",
                       "twingan_tpu/ops/attention.py:54"),
    "flash_attn_dq": ("twingan_tpu_torch/csrc/flash_attn_bwd.cu",
                      "twingan_tpu/ops/attention.py:127"),
    "flash_attn_dkv": ("twingan_tpu_torch/csrc/flash_attn_bwd.cu",
                       "twingan_tpu/ops/attention.py:153"),
    "fused_conv": ("twingan_tpu_torch/csrc/fused_conv.cu", "tools/exp_fused_conv.py:76"),
    # Q1 replaces no Pallas kernel: the JAX package's int8 conv is
    # lax.conv_general_dilated(..., preferred_element_type=int32); its
    # entry conv_i8q also takes in the activation's quantize.
    "conv_i8": ("twingan_tpu_torch/csrc/conv_i8.cu", "twingan_tpu/ops/quant.py:69"),
    "conv_i8q": ("twingan_tpu_torch/csrc/conv_i8.cu", "twingan_tpu/ops/quant.py:54"),
}

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bound of a call is
# the largest of its bytes over the memory rate, its FLOPs over the peak of
# its route (the kernel variant that ran: bf16 products on the tensor cores,
# fp32 products on the CUDA cores, or, for the 3xTF32 variants, three TF32
# products a multiply-add on the tensor cores: PRODUCTS) and, for
# attention, its exponentials over the special-function units' rate: 16
# base-2 exponentials a clock on each SM (the CUDA C++ Programming Guide's
# instruction throughput table, compute capability 9.0; the
# FlashAttention-3 paper gives 3.9 T/s for the H100 SXM), at the card's top
# SM clock, which the device phase reads from nvidia-smi.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"tensor_core": 989e12, "tensor_core_cluster": 989e12, "cuda_core": 67e12,
              "tensor_core_tf32x3": 494.5e12}
PRODUCTS = {"tensor_core_tf32x3": 3}  # hi hi + hi lo + lo hi
EXP_PER_SM_CLOCK = 16
exp_per_s = 3.9e12  # replaced by device_phase with the card's SMs x 16 x top clock

# (label, B, N, c_bar, C, dtype). The serving shape is the main path's: the
# client pads every batch to 4, and attention sits at 64 px (N = 4096) with
# C = 64 and c_bar = C / 8 in both the encoder and the generator.
SERVING_CASE = ("serving batch", 4, 4096, 8, 64, "bfloat16")
# The same shape in the JAX package's default type, fp32 (the fp32 phase).
FP32_SERVING_CASE = ("serving batch", 4, 4096, 8, 64, "float32")
# (label, B, N, c_bar, C) of the widths past the register-held kernels.
WIDE_ATTENTION_CASES = [
    ("C 512, 8 px", 4, 64, 64, 512),
    ("C 1024, 4 px", 4, 16, 128, 1024),
    ("C 2048, 16 px", 2, 256, 256, 2048),
    ("ragged N, C 512", 2, 1000, 64, 512),
]
KERNEL_CASES = [
    ("slice", 8, 4096, 8, 64, "bfloat16"),
    ("slice", 8, 4096, 8, 64, "float32"),
    SERVING_CASE,
    FP32_SERVING_CASE,
    ("ragged N", 2, 1000, 8, 64, "float32"),
    ("ragged N", 2, 1000, 8, 64, "bfloat16"),
    ("c_bar 1, C 8", 2, 4096, 1, 8, "float32"),
    ("c_bar 32, C 256", 2, 4096, 32, 256, "bfloat16"),
    # The widest register-held fp32 instantiation (4 slices of 64 columns).
    ("c_bar 64, C 256", 2, 4096, 64, 256, "float32"),
    ("docs/PERFORMANCE.md", 4, 4096, 32, 64, "float32"),
    ("docs/PERFORMANCE.md", 4, 16384, 32, 64, "float32"),
    # The tensor-core variant's per-tile sums of l over 256 tiles of keys.
    ("long N", 2, 16384, 8, 64, "bfloat16"),
] + [
    # Every width the JAX layers produce: past c_bar 64 and (fp32) C 256
    # the entry point takes csrc/flash_wide.cuh's kernels. C 512 at 8 px
    # (the published PGGAN width), C 1024 at 4 px (c_bar 128), C 2048 at
    # 16 px (c_bar 256), a ragged N at C 512, in both types.
    (label, b, n, c_bar, c, dtype)
    for label, b, n, c_bar, c in WIDE_ATTENTION_CASES for dtype in ("bfloat16", "float32")
] + [
    # min_channels 512 with attention at 64 px: C 512 at N 4096, for its time.
    ("C 512 at 64 px", 4, 4096, 64, 512, "bfloat16"),
]

# (label, B, N, c_bar, C, dtype) for the backward kernels. The training
# shape is the main path's: batch 3 (TWINGAN_BATCH_SCHEDULE[256]), attention
# at 64 px in the encoder, the generator and both discriminators.
TRAIN_CASE = ("train batch", 3, 4096, 8, 64, "bfloat16")
FP32_TRAIN_CASE = ("train batch", 3, 4096, 8, 64, "float32")
BWD_CASES = [
    TRAIN_CASE,
    FP32_TRAIN_CASE,
    ("ragged N", 2, 1000, 8, 64, "float32"),
    ("ragged N", 2, 1000, 8, 64, "bfloat16"),
    ("c_bar 1, C 8", 2, 4096, 1, 8, "float32"),
    ("c_bar 32, C 256", 2, 4096, 32, 256, "bfloat16"),
    ("c_bar 64, C 256", 2, 4096, 64, 256, "float32"),
    ("docs/PERFORMANCE.md", 4, 4096, 32, 64, "float32"),
    ("docs/PERFORMANCE.md", 4, 16384, 32, 64, "float32"),
    ("docs/PERFORMANCE.md", 4, 65536, 32, 64, "float32"),
    # The tensor-core dkv's fp32 sums of dh and dg over 128 query tiles.
    ("long N", 2, 16384, 8, 64, "bfloat16"),
] + [
    (label, b, n, c_bar, c, dtype)
    for label, b, n, c_bar, c in WIDE_ATTENTION_CASES for dtype in ("bfloat16", "float32")
] + [("C 512 at 64 px", 4, 4096, 64, 512, "bfloat16")]
# Above this N the plain version's N^2 matrices (68 GB at N 65536, B 4)
# do not fit: such a case is checked against a reference chunked over query
# rows, the plain versions are not timed, and the kernels are timed over
# fewer launches.
PLAIN_MAX_N = 16384
REFERENCE_ROWS = 2048
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION", "MATH")

# Kernel B4 (fused conv3x3 SAME + bias + leaky + pixel norm): (label, B,
# H = W, Cin, Cout, dtype, layers of one generator pass at this shape).
# The TPU script's shape (tools/exp_fused_conv.py defaults), every distinct
# conv-leaky-pixel-norm layer of pggan256 at its batch of 12 (block_4_conv1,
# then conv0 and conv1 at 8 to 256 px: 13 layers a pass) in bf16 and in
# fp32 (the JAX package's default type: the fp32 phase's generation and
# sample run them), a ragged case (20 x 20, Cout not a multiple of 8) in
# each type and a ragged Cin at 5 x 5 in fp32. Then the widths past
# 256 channels: the published PGGAN width (fmap_max 512) at 4 and 8 px,
# the widest the config gives (1024 at 4 px), and two with n8 tiles past
# Cout (300 and 520).
GEN_BATCH = 12
# (label, H = W, Cin, Cout, layers a pass) of pggan256's generator.
GEN_LAYERS = [
    ("pggan256 block_4_conv1", 4, 256, 256, 1),
    ("pggan256 block_8_conv0/1", 8, 256, 256, 2),
    ("pggan256 block_16_conv0/1", 16, 256, 256, 2),
    ("pggan256 block_32_conv0", 32, 256, 128, 1),
    ("pggan256 block_32_conv1", 32, 128, 128, 1),
    ("pggan256 block_64_conv0", 64, 128, 64, 1),
    ("pggan256 block_64_conv1", 64, 64, 64, 1),
    ("pggan256 block_128_conv0", 128, 64, 32, 1),
    ("pggan256 block_128_conv1", 128, 32, 32, 1),
    ("pggan256 block_256_conv0", 256, 32, 16, 1),
    ("pggan256 block_256_conv1", 256, 16, 16, 1),
]
FUSED_CONV_CASES = [
    ("exp_fused_conv.py", 8, 256, 16, 16, "bfloat16", 0),
] + [
    (label, GEN_BATCH, hw, cin, cout, dtype, per_pass)
    for dtype in ("bfloat16", "float32") for label, hw, cin, cout, per_pass in GEN_LAYERS
] + [
    ("ragged", 4, 20, 40, 20, "bfloat16", 0),
    ("ragged", 4, 20, 40, 20, "float32", 0),
    ("ragged Cin, 5 px", 3, 5, 19, 13, "float32", 0),
    ("fmap_max 512, block_4_conv1", GEN_BATCH, 4, 512, 512, "bfloat16", 0),
    ("fmap_max 512, block_8_conv0/1", GEN_BATCH, 8, 512, 512, "bfloat16", 0),
    ("1024 channels, block_4_conv1", GEN_BATCH, 4, 1024, 1024, "bfloat16", 0),
    ("wide ragged, Cout 300", 2, 20, 24, 300, "bfloat16", 0),
    ("wide, Cout 520", 2, 8, 16, 520, "float32", 0),
] + [
    # Past one block's 1024 channels (min_channels above 1024): tiles of
    # 256 channels, one cluster a pixel tile, in one pass up to 2048 (5
    # tiles, the last of 8 channels; 6; 8), then two passes (9 tiles).
    (f"Cout {cout}, {hw} px", 2, hw, cout, cout, dtype, 0)
    for cout, hw in ((1032, 4), (1536, 16), (2048, 32), (2056, 4))
    for dtype in ("bfloat16", "float32")
]
GEN_LAYERS_PER_PASS = 13

# Serving-path agreement with the fp32 CPU run, in units of the CPU
# output's standard deviation. bf16 keeps 8 significant bits and every
# layer rounds its activations; the same weights at 32 px (half the depth)
# in bf16 on the CPU differ from fp32 by 0.027 (mean) and 0.12 (max) of the
# std, so twice that depth gets 0.1 and 0.5. The check also requires that
# switching attention off (every sa_gamma 0) moves the fp32 output by more
# than the mean tolerance, so it can tell a wrong attention from a right one.
SERVE_MEAN_TOL = 0.1
SERVE_MAX_TOL = 0.5
# fp32 serving (the serving phase's second run) against the same CPU run:
# both sum fp32 products in other orders, B1 as 3xTF32 (about 2^-21 a
# product), so the card read 9.3e-7 (mean) and 1.0e-5 (max) of the std on
# an H100. One TF32 product (2^-11) in cuDNN and the matmuls read 3.9e-4
# and 3.7e-3 (bf16: 0.012 and 0.087); the phase runs that too and requires
# it to exceed these limits, so that they tell fp32 from TF32.
SERVE_TOLS = {"bfloat16": (SERVE_MEAN_TOL, SERVE_MAX_TOL), "float32": (1e-4, 1e-3)}
REQUESTS_PER_ROUND = 8
TIMED_ROUNDS = 3
# The http phase: the port's HTTP server on 127.0.0.1, the serving phase's
# stage behind BatchingLocalClient (batches of 4), the Haar detector in 2
# worker processes, at most 4 faces a request; the faces image (10 faces)
# posted 8 at a time, the forms in turn, a warm-up round and a timed one.
HTTP_FACES = "tests/data/real_faces_gallery.png"
HTTP_REQUESTS = 8
HTTP_MAX_FACES = 4
HTTP_SERVE_BATCH = 4
HTTP_DETECTOR_PROCS = 2
HTTP_FORMS = ("raw", "multipart", "base64")

# Training: TWINGAN_BATCH_SCHEDULE[256] of the JAX stage runner.
TRAIN_BATCH = 3
TRAIN_TIMED_ROUNDS = 3
# One G step and one D step on the card against the same steps in fp32 on
# the CPU with the plain attention, from the same weights, batches and
# penalty noise: (loss rtol, loss atol, min cosine of each network's
# gradient, min cosine of each attention projection's gradient).
# - float32 on the card checks the kernels inside training. The CPU's own
#   sensitivity bounds it: multiplying every weight by (1 + 1e-7 N(0,1))
#   moves the fp32 gradients of a 64 px batch-norm model by up to 5e-4 of
#   the largest one (tests/test_torch_twingan_step.py), and the kernels
#   agree with the plain version to 1e-4; a wrong dq or dkv kernel would
#   turn the projections' gradients around. Limits 1e-3 / 1e-4 / 0.999 /
#   0.999.
# - bfloat16 is the main path's type; every layer rounds activations and
#   gradients to 8 bits. The same comparison with the CPU in the card's
#   place at 64 px (tests/test_torch_twingan_step.py runs it) moves losses
#   by about 2 % (0.09 absolute), network cosines down to about 0.8 (the
#   encoder, through batch-norm backward in bf16) and projection cosines
#   to about 0.75. The limits leave room for the depth of 256 px: losses
#   0.1 relative + 0.1 absolute, network cosine 0.5; the projections are
#   reported and held only by the fp32 check.
TRAIN_LIMITS = {"float32": (1e-3, 1e-4, 0.999, 0.999),
                "bfloat16": (0.1, 0.1, 0.5, None)}

# Generation: the PGGAN generator at 256 px (Karras et al. 2018; the JAX
# pggan_runner's flags with --generator_norm_type none --do_pixel_norm
# --equalized_learning_rate), batch 12 (its 256 px schedule). The step
# comparison with the CPU runs batch 4, to keep the CPU's fp32 D step (the
# penalty's double backward at full depth) short; the sample comparison
# uses serving's limits.
GEN_COMPARE_BATCH = 4
GEN_TIMED_ROUNDS = 3

# The runner phase: images a resolution for pggan256 (3 rounds at batch 16
# below 64 px, 4 at batch 12 from 64 px), the stages of its first call, and
# images a resolution for the TwinGAN plan (2 rounds at batch 4 and 3).
RUNNER_PGGAN_IMAGES = 48
RUNNER_FIRST_CALL_STAGES = 7
RUNNER_TWINGAN_IMAGES = {128: 8, 256: 6}
# One pggan256 stage at 256 px long enough that the first round and the
# writes are spread over many rounds: 40 rounds at batch 12, a checkpoint
# every 20 steps (2 checkpoints and model.pt).
RUNNER_LONG_STAGE_IMAGES = 480
RUNNER_LONG_STAGE_SAVE_EVERY = 20

# The data phase: a dataset of two domains, A and B, each of DATA_IMAGES
# smooth random images written as PNG in DATA_SHARDS tfrecord shards; half
# of each domain at each shape (H, W), so that PAD really resamples.
DATA_IMAGES = 512
DATA_SHARDS = 4
DATA_SHAPES = ((256, 256), (320, 272))
DATA_RESIZE_HW = (4, 32, 256)
DATA_TIMED_IMAGES = 32  # of each shape, per timed resize size
# The runner_data phase: the in-training SWD every 3 steps fires once at
# every stage from 16 px on (3 or 4 rounds a stage); the streaming 256 px
# stage's rounds, held bit-equal to the resident stage's first ones.
RUNNER_DATA_SWD_EVERY = 3
RUNNER_DATA_STREAM_ROUNDS = 10
# The eval phase: run_eval's modes on the TwinGAN run's final stage. The
# reference SWD protocol takes 8192 images; 2048 (2 x 1.6 GB of float32,
# past the 512 MiB switch to the chunked path) is a cut for time.
EVAL_BATCH = 16
EVAL_SWD_IMAGES = 2048
EVAL_MSSSIM_IMAGES = 256
EVAL_LOSS_IMAGES, EVAL_LOSS_BATCH = 64, 8
EVAL_OUTPUT_IMAGES = 64
# The card's SWD and MS-SSIM of EVAL_COMPARE_IMAGES fixed images against
# the CPU's with the same draws, to the tolerances the CPU tests hold the
# port to against the JAX package (tests/test_torch_evals.py): the sorts
# and reductions run in another order.
EVAL_COMPARE_IMAGES = 128
SWD_RTOL = 1e-4
MSSSIM_ATOL = 1e-5

# The recipe phase: the reference's headline TwinGAN recipe (docs/USAGE.md,
# "Train TwinGAN from scratch") as the port's training command takes it,
# plus the slice's SAGAN attention at 64 px, on synthetic data. Its step
# comparison starts at global step 10001, where the schedule's second clip
# holds, from renorm EMAs drawn from the seed (at their zero init r is 1
# and d is 0, and no clip would bite). 16 images a resolution: 2 rounds a
# stage at batch 8 below 128 px, 4 at 128 px (batch 4), 5 at 256 px
# (batch 3).
RECIPE_FLAGS = [
    "--program_name=twingan", "--dataset_split_name=train",
    "--resize_mode=RESHAPE", "--do_random_cropping=true", "--learning_rate=0.0001",
    "--generator_network=pggan", "--use_unet=true",
    "--loss_architecture=dragan", "--gradient_penalty_lambda=0.25",
    "--pggan_max_num_channels=256", "--generator_norm_type=batch_renorm",
    "--hw_to_batch_size={4: 8, 8: 8, 16: 8, 32: 8, 64: 8, 128: 4, 256: 3, 512: 2}",
    "--do_pixel_norm=true", "--l_content_weight=0.1", "--l_cyc_weight=1.0",
    "--dtype=bfloat16", "--rounds_per_scan=16",
    "--do_self_attention=true", "--self_attention_hw=64",
]
RECIPE_IMAGES = 16
RECIPE_STEP = 10001
# A spectral norm's u after a step, card against CPU: one power iteration
# in fp32 from the same u on the same fp32 weights (TF32 off), sums taken
# in other orders; u is a unit vector.
SPECTRAL_U_ATOL = 1e-5

# The options phase: the trainer options on the slice config (the style
# embedding 16 wide, so that the generator's norms are conditional;
# distillation against 512-wide unit embeddings, as celeba_facenet's; gdrop;
# remat) and on pggan256 (gdrop; conditional labels over anime_faces' 51
# classes, embedded 32 wide; rmsprop, then adagrad, adadelta and ftrl). The
# steps start at global step 101, past the schedule's gdrop switch, with the
# strength 0.05 that the schedule reaches at most at its defaults (coef 0.2
# x (1 - lim 0.5) ** 2). The CLI plan trains 2 rounds a stage from 128 to
# 256 px and dumps its sample grids at the stages' last step.
OPTIONS_STYLE_DIM = 16
OPTIONS_EMBED_DIM = 512
OPTIONS_STEP = 101
OPTIONS_GDROP_STRENGTH = 0.05
OPTIONS_NUM_CLASSES = 51
OPTIONS_COND_DIM = 32
OPTIONS_CLI_IMAGES = 8
# The TwinGAN options' G and D step on the card in float32 against float32
# on the CPU, at TRAIN_LIMITS' float32 row. bf16 against fp32 at random
# init measures how far this config amplifies rounding, not the kernels
# (whose bf16 variants the train phase holds): its style path doubles the
# depth behind every conditional norm. On an NVIDIA H100 80GB HBM3 at
# 700.00 W the bf16 step gave fool losses 40 % off (13.0 against 9.3) and
# content and style encoder cosines of 0.78; on the CPU at 64 px the
# generator's gradient norm moves 25 % and the content encoder's cosine
# falls to 0.86. The options' bf16 rounds run in the timed rounds and the
# CLI plan, held to finite losses and their launches, all tensor-core.
OPTIONS_TWINGAN_LIMITS = {"float32": TRAIN_LIMITS["float32"]}
OPTIONS_CLI_FLAGS = [
    "--program_name=twingan", "--use_synthetic_data=true", "--start_hw=128", "--max_hw=256",
    f"--num_images_per_resolution={OPTIONS_CLI_IMAGES}", "--pggan_max_num_channels=256",
    "--generator_norm_type=batch_norm", "--equalized_learning_rate=true",
    "--do_pixel_norm=true", "--use_unet=true", "--dtype=bfloat16", "--do_self_attention=true",
    "--self_attention_hw=64", "--use_style_embedding=true",
    f"--style_embed_size={OPTIONS_STYLE_DIM}", "--use_gdrop=true", "--remat=true",
    "--log_every_n_steps=1", "--log_image_every_n_iter=2", "--save_every_n_steps=2",
]

# The classifiers phase: each network of the zoo at its reference input
# size (the JAX nets' default_image_size), its logits at batch 2 on the card
# held to ZOO_RTOL of the CPU's largest (fp32 both, TF32 off; the convs'
# algorithms sum in other orders through up to 200 layers) and timed at
# batch 32 over ZOO_TIMED_REPS launches after warm-ups. The largest error
# measured was 3.57e-6 (overfeat), the same in five calls (NVIDIA H100 80GB
# HBM3, 700.00 W).
ZOO_SIZES = {"lenet": 28, "cifarnet": 32, "alexnet_v2": 224, "overfeat": 231, "vgg_a": 224,
             "vgg_16": 224, "vgg_19": 224, "illust2vec": 224, "resnet_v1_50": 224,
             "resnet_v1_101": 224, "resnet_v2_50": 224, "resnet_v2_101": 224,
             "resnet_v2_layernorm": 224, "mobilenet_v1": 224, "inception_v1": 224,
             "inception_v2": 224, "inception_v3": 299, "inception_v4": 299,
             "inception_resnet_v2": 299, "nasnet_mobile": 224, "nasnet_large": 331}
ZOO_CLASSES = {"illust2vec": 1539}
ZOO_COMPARE_BATCH, ZOO_TIMED_BATCH, ZOO_TIMED_REPS = 2, 32, 5
ZOO_RTOL = 1e-4
# The reference tagger through the classifier CLI: its defaults (rmsprop,
# lr 0.01, weight decay 4e-5, batch 32, 1539 classes) at 224 px on
# synthetic data; 20 steps where a tagger trains 100k, as a run of
# TAGGER_EARLY_STEP steps and its resumption to 20 (the resumed run draws
# its synthetic batches from the seed again). The CLI builds a fixed
# learning rate, as the JAX CLI does; the config's exponential decay (0.94
# every 10000 steps) is the same rate for the first 10000.
TAGGER_STEPS, TAGGER_EARLY_STEP = 20, 1
TAGGER_FLAGS = ["--model_name=illust2vec", "--train_image_size=224", "--num_classes=1539",
                "--batch_size=32", "--optimizer=rmsprop", "--learning_rate=0.01",
                "--weight_decay=0.00004", "--use_synthetic_data",
                f"--max_number_of_steps={TAGGER_STEPS}", "--log_every_n_steps=10",
                "--num_eval_batches=4", "--gradcam_layer=conv5", f"--seed={SEED}"]
# One more step from the checkpoint of TAGGER_EARLY_STEP, card against CPU
# at batch 4 (the CPU's fp32 step at batch 32 takes tens of seconds): the
# loss and the gradient's cosine within TRAIN_LIMITS' fp32 row, the
# update's cosine at least TAGGER_UPDATE_COS. The step is taken that early
# because the loss diverges from a random init at these defaults (0.693 to
# 1e8-1e11 by step 20) and leaves units dead, whose rmsprop update (about
# lr g / 1e-4) carries g's rounding. From step 20 the update's cosine
# measured 0.99913 to 0.99992 in five calls, the gradients' 1 - 1e-12
# (NVIDIA H100 80GB HBM3, 700.00 W). The Grad-CAM maps of the trained
# state (normalized to [0, 1]) within CAM_ATOL: 4.2e-7 to 1.4e-6 measured
# in the same five calls.
TAGGER_COMPARE_BATCH = 4
TAGGER_UPDATE_COS = 0.999
CAM_ATOL = 1e-4
# The FID classifier: artifacts/fid_classifier's config (cifarnet, 12
# labels, 32 px, batch 64, adam lr 0.003, no weight decay) through the CLI,
# 200 steps on synthetic data where the artifact trained 1500 on the
# domain generator's labels.
FID_CLASSIFIER_FLAGS = ["--model_name=cifarnet", "--train_image_size=32", "--num_classes=12",
                        "--batch_size=64", "--optimizer=adam", "--learning_rate=0.003",
                        "--weight_decay=0", "--use_synthetic_data",
                        "--max_number_of_steps=200", "--log_every_n_steps=100",
                        f"--seed={SEED}"]
# FID and the inception score on the TwinGAN run's final stage: 256
# images a mode where FID's protocol takes 50000 (and the reference's
# inception score 50000 in 10 splits), batches of 16. The card's features
# and FID of FID_COMPARE_IMAGES fixed real and as many fixed fake images
# against the CPU's with the same weights (fp32 both, TF32 off): the
# features' mean and largest errors within FEATURES_MEAN_TOL and
# FEATURES_MAX_TOL of the CPU's std, FID within FID_CARD_RTOL. Measured in
# four calls (NVIDIA H100 80GB HBM3, 700.00 W): the errors at most 3.3e-7
# and 3.5e-6 of the std (inception), 3.6e-8 and 1.8e-6 (classifier); FID
# 1.3e-6 and 5.1e-7 relative.
FID_IMAGES, FID_BATCH = 256, 16
FID_COMPARE_IMAGES = 32
FEATURES_MEAN_TOL, FEATURES_MAX_TOL = 1e-5, 1e-4
FID_CARD_RTOL = 1e-4

# W8A8 int8 serving (kernel Q1, csrc/conv_i8.cu). Q1's two entries against
# their plain versions at every distinct conv of the slice config at the
# serving batch (the shapes the int8 translate gives it, read by hooks),
# plus the fused-scale up conv (dilation 2, 4x4, padding 2, which the slice
# config does not run) and a ragged Cin: the int32 sums and the fp32 and
# bf16 outputs bit-equal. Then the slice config served in int8 through
# BatchingLocalClient: a warm-up past CALIB_MIN_IMAGES, then timed rounds.
# Card against CPU (fp32 both, the card's calibrated abs-maxima copied to
# the CPU). Each conv given the CPU's input must give the CPU's output bit
# for bit (the quantize, Q1 and its epilogue are exact or the same IEEE
# operations on both). Free-running, the first conv's input is the image,
# identical on both, so its codes must agree; the next input has been
# through batch norm's rsqrt and the pixel norm's channel sum, whose last
# bits differ, and flips a code that lies within them of a rounding
# boundary: at most INT8_SECOND_FLIP_TOL of them. A flip moves the next
# conv by a whole quantization step, so deeper layers decorrelate (my chip
# run 1 of PR 15: 47 % of one layer's codes flipped): the output then
# differs by about the int8 noise itself, and is held to
# INT8_CPU_MEAN_NOISE_TOL times the CPU int8 output's mean distance from
# its fp32 output, and its largest difference to INT8_CPU_MAX_TOL of the
# std (serving's limit).
INT8_CPU_BATCH = 2
INT8_SECOND_FLIP_TOL = 1e-3
INT8_CPU_MEAN_NOISE_TOL = 2.0
INT8_CPU_MAX_TOL = 0.5
INT8_UP_CASE = ("fused-scale up (dilation 2)", 4, 64, 64, 32, 4, (2, 2, 2, 2), 2)
INT8_RAGGED_CASE = ("ragged Cin", 4, 32, 10, 24, 3, (1, 1, 1, 1), 1)
INT8_OPS_PER_S = 1979e12

# The parallel phase: a real NCCL process group of one process on the card.
# At one process every collective returns its input's values exactly, so
# each path under the group must equal the same path without it bit for
# bit. The context-parallel core at the serving and training shapes of
# attention (bf16); then its per-process core at two processes' split of the
# keys (two blocks, each through B1-B3) against the plain version.
PARALLEL_CORE_CASES = [SERVING_CASE, TRAIN_CASE]
PARALLEL_SPLIT = 2
PARALLEL_PLAN_IMAGES = 32   # per resolution: 2 rounds at the schedule's batch 16 below 64 px
PARALLEL_FIRST_CALL_STAGES = 3

# The alt_gans phase: the alternative networks at published widths, fp32 on
# the card (TF32 off) against the same calls on the CPU with the same
# weights and injected noise. DCGAN (Radford et al. 2016) at 64 px: depth
# 64, latent 100, batch 128; CycleGAN (Zhu et al. 2017) at 256 px: 64
# filters, batch 1, the trainer's 6 residual blocks (the generator alone at
# 9 in each decoder); pix2pix (Isola et al. 2017): the U-Net-256 of base 64
# and the 70x70 PatchGAN on the 6-channel pair, batch 1. The steps are held
# to TRAIN_LIMITS["float32"] (losses 1e-3 relative + 1e-4, gradient
# cosines 0.999; these networks have no attention projections). A forward
# (sample, the generators alone, pix2pix) is held to ALT_FORWARD_TOL of the
# output's magnitude (at least 1): fp32 on both sides, 20-50 convs each
# summing in its own order, and pix2pix's train-mode batch norm over batch
# 1 at 2x2 divides by the deviation of four values. The TF1 import mapping runs without TensorFlow over the
# TwinGAN slice config's weights; its 256 px batch must be bit-equal.
ALT_DCGAN = {"resolution": 64, "depth": 64, "latent": 100, "batch": 128}
ALT_CYCLEGAN = {"resolution": 256, "filters": 64, "batch": 1, "blocks_alone": 9}
ALT_PIX2PIX = {"resolution": 256, "base": 64, "batch": 1}
ALT_TIMED_ROUNDS = 20
ALT_RUNNER_ROUNDS = 4
ALT_RUNNER_EVERY = 2
ALT_IMPORT_BATCH = 4
ALT_FORWARD_TOL = 1e-3
# CycleGAN's discriminator pools its trunk by a spatial mean, and the mean
# of an instance-normalized residual branch is its norm's bias alone: in
# the D loss (and the penalty) the gradients of every residual block's
# first conv and norm (``block_<b>_conv0``) are 0 in exact arithmetic,
# rounding noise on both sides (cosines near 0 between an H100 and the
# CPU). Those modules, and no others, are held by their largest absolute
# difference from the CPU's gradient, at most ZERO_GRAD_ATOL (about 30x the
# 3.6e-8 an H100 showed, where the D step's gradient norm is about 1).
ZERO_GRAD_ATOL = 1e-6

# The wide phase: every channel width the JAX package runs (wide_configs).
# The 512-channel config's G and D steps are held against the CPU at 16 px
# (the attention layer's shape, C 512 at 8 px, is the same; the CPU's
# 256 px steps would take most of the phase); the 2048-channel pggan256 is
# cut to 32 px (7 B4 layers a generator pass) for its counted D step and
# its sample, held against the CPU at batch 2, and its D step is held
# against the CPU at 16 px (the same 2048-channel layers; at 32 px the
# CPU's step alone took 23 s of the minute).
WIDE_SERVE_BATCHES = 2
WIDE_COMPARE_RESOLUTION = 16
WIDE_GEN_RESOLUTION = 32
WIDE_GEN_BATCH = 2
WIDE_GEN_LAYERS_PER_PASS = 7

# Numbers an earlier phase measured that a later one prints beside its own.
MEASURED: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def start_watchdog() -> None:
    def fire():
        emit({"phase": "watchdog", "ok": False,
              "error": f"chip_smoke.py still running after {WATCHDOG_S} s"})
        os._exit(3)

    timer = threading.Timer(WATCHDOG_S, fire)
    timer.daemon = True
    timer.start()


def tolerance(dtype: str, ref_max: float) -> float:
    """Kernel vs plain version, max abs error on the output. fp32: the
    kernel sums N terms sequentially per row where the plain matmul sums
    blockwise, 1e-4 of the output's magnitude. bf16: both round the same
    fp32 result to 8 significant bits, so up to one unit in the last place
    (1/128 of the magnitude) apart, plus the plain version's bf16 cast of
    the probabilities: 1/64 of the magnitude."""
    scale = max(1.0, ref_max)
    return scale * (1e-4 if dtype == "float32" else 1.0 / 64)


def grad_tolerance(dtype: str, ref_max: float, n: int) -> float:
    """Backward kernels vs autograd of the plain version, max abs error on
    each gradient. fp32: 1e-4 of the gradient's magnitude (sequential sums
    over N) up to N 16384; the rounding error of a sum of N terms grows as
    sqrt(N) (measured: 2.3e-5 of the magnitude at N 4096, 5.7e-5 at 16384),
    so beyond 16384 the share grows as sqrt(N / 16384). bf16: the same
    inputs; the kernels sum in fp32 and round each output once (1/256 of
    the magnitude), and delta = rowsum(do * o) takes the forward kernel's
    bf16 output where the reference has the exact probabilities (up to
    another 1/256 of the largest term): 1/64."""
    scale = max(1.0, ref_max)
    if dtype != "float32":
        return scale / 64
    return scale * 1e-4 * max(1.0, (n / PLAIN_MAX_N) ** 0.5)


def chunked_reference(f, g, h, do, rows: int = REFERENCE_ROWS):
    """Exact fp32 attention forward and backward by the formulas of the
    plain versions, over chunks of ``rows`` query rows (O(rows * N)
    memory): (o, lse, df, dg, dh)."""
    import torch

    f, g, h, do = (t.float() for t in (f, g, h, do))
    o, lse, df = torch.empty_like(h), torch.empty(f.shape[:2], device=f.device), torch.empty_like(f)
    dg, dh = torch.zeros_like(g), torch.zeros_like(h)
    for i in range(0, f.shape[1], rows):
        fi, doi = f[:, i:i + rows], do[:, i:i + rows]
        s = torch.matmul(fi, g.transpose(1, 2))
        lse[:, i:i + rows] = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[:, i:i + rows, None])
        o[:, i:i + rows] = torch.matmul(p, h)
        delta = torch.sum(doi * o[:, i:i + rows], dim=-1)
        ds = p * (torch.matmul(doi, h.transpose(1, 2)) - delta[..., None])
        df[:, i:i + rows] = torch.matmul(ds, g)
        dg += torch.matmul(ds.transpose(1, 2), fi)
        dh += torch.matmul(p.transpose(1, 2), doi)
    return o, lse, df, dg, dh


def device_phase():
    import torch

    if not torch.cuda.is_available():
        fail("device", "no CUDA device: chip_smoke.py runs the port on the card only")
    if not os.path.isdir(os.path.join(REPO, "twingan_tpu_torch")):
        fail("device", f"twingan_tpu_torch not found beside chip_smoke.py in {REPO}")
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("device", f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    try:
        sm_mhz = float(clock.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail("device", f"nvidia-smi gave no top SM clock: {clock.stdout!r} {clock.stderr!r}")
    global exp_per_s
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_per_s = sms * EXP_PER_SM_CLOCK * sm_mhz * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "sms": sms, "max_sm_clock_mhz": sm_mhz,
          "exponentials_per_s": exp_per_s, "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": "off for matmul and cuDNN"})
    return name, smi_line


def build_phase():
    from twingan_tpu_torch.ops import attention, cuda_build, fused_conv, quant

    names = (attention.KERNEL_NAME, attention.BWD_LIBRARY, fused_conv.KERNEL_NAME,
             quant.KERNEL_NAME)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        list(pool.map(cuda_build.build, names))
    for name in names:
        cuda_build.load(name)
    seconds = time.perf_counter() - t0
    for name in names:
        emit({"phase": "build", "ok": True, "library": name, "seconds": round(seconds, 3),
              "nvcc_seconds": cuda_build.build_info[name]["seconds"],
              "ptxas": ptxas_usage(cuda_build.build_info[name]["log"])})


def ptxas_usage(log: str) -> list:
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``: the
    entry's (mangled) name, then its "N bytes spill stores, M bytes spill
    loads" and "Used R registers" lines."""
    rows, row = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            row = {"kernel": ln.split("'")[1] if "'" in ln else ln.strip()}
            rows.append(row)
        elif row is not None and "spill stores" in ln:
            row["spills"] = ln.strip()
        elif row is not None and "registers" in ln:
            row["registers"] = ln.split(":", 1)[1].strip()
    return rows


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` launches, each timed by CUDA events, after 3 warm-ups."""
    import torch

    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn``'s launches, queued back to back: the
    launches are enqueued while the card spins (``torch.cuda._sleep``), so
    the events time the kernels and not the host's dispatch between them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))  # about 10 ms: longer than enqueueing reps calls
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def _bound(nbytes: float, flops: float, route: str, exps: float = 0.0) -> tuple[float, str]:
    """The largest of the three times, and which it is: ``flops`` are the
    call's multiply-adds times 2, taken ``PRODUCTS[route]`` times."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": PRODUCTS.get(route, 1) * flops / PEAK_FLOPS[route],
             "exponentials": exps / exp_per_s}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def bound(b: int, n: int, c_bar: int, c: int, dtype: str, route: str) -> tuple[float, str]:
    """Least time of the forward on the card by ``route``: each input read
    once, each output written once, the two products' FLOPs at the route's
    peak, and the B N^2 exponentials at the special-function units' rate."""
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (2 * b * n * c_bar + b * n * c) + elt * b * n * c + 4 * b * n
    return _bound(nbytes, 2.0 * b * n * n * (c_bar + c), route, b * n * n)


def bwd_bounds(b: int, n: int, c_bar: int, c: int, dtype: str, routes: dict) -> dict:
    """Least times of the dq and the dkv kernel, each by its route
    (``routes[name]``): f, g, h, do read once, lse and delta (fp32) read
    once, the outputs written once. dq recomputes s = f g^T and dp = do h^T
    and forms df = ds g: 2 B N^2 (2 c_bar + C) FLOPs; dkv adds dh = p^T do
    and dg = ds^T f: 2 B N^2 (2 c_bar + 2 C). Each recomputes the B N^2
    probabilities: as many exponentials."""
    elt = 4 if dtype == "float32" else 2
    inputs = elt * (2 * b * n * c_bar + 2 * b * n * c) + 8 * b * n
    return {"flash_attn_dq": _bound(inputs + elt * b * n * c_bar,
                                    2.0 * b * n * n * (2 * c_bar + c), routes["flash_attn_dq"],
                                    b * n * n),
            "flash_attn_dkv": _bound(inputs + elt * b * n * (c_bar + c),
                                     2.0 * b * n * n * (2 * c_bar + 2 * c),
                                     routes["flash_attn_dkv"], b * n * n)}


FP32_ROUTES = ("cuda_core", "tensor_core_tf32x3")


def expected_variant(kernel: str, dt, c_bar: int, c: int) -> str:
    """The variant a kernel row expects the C entry point of ``kernel`` to
    report (the entry points pick it; this is the check's own statement):
    the register-held kernels up to c_bar 64 and C 256, csrc/flash_wide.cuh's
    past them (for the bf16 forward, whose kernel takes any C in 64-column
    slices, both are the tensor-core variant; the bf16 dq and dkv past them
    are the cluster variant, ``wide_bf16_kernel``)."""
    from twingan_tpu_torch.ops import attention

    if c_bar > 64 or c > 256:
        return attention.WIDE_VARIANTS[kernel][dt]
    return attention.VARIANTS[kernel][dt]


def ran_variants(kernel: str) -> list:
    """The variants of ``kernel`` launched since the last reset."""
    from twingan_tpu_torch.ops import attention

    return [k.split("/", 1)[1] for k, v in attention.variant_counts.items()
            if v and k.startswith(kernel + "/")]


def fused_conv_bound(b: int, hw: int, cin: int, cout: int, dtype: str,
                     route: str = "") -> tuple[float, str]:
    """Least time of B4 on the card by ``route`` (default: the route of the
    variant x's type runs, ``fused_conv.VARIANTS``): x read and y written
    once in their type, the fp32 weights and bias read once, against the
    conv's FLOPs at the rate of the route's products. fp32 (TF32 tensor
    cores): three TF32 products a multiply-add at 494.5 TFLOP/s
    (``PRODUCTS``); on the CUDA cores one FMA at 67. bf16 (tensor cores):
    each multiply-add by an fp32 weight is two bf16 products (the weight's
    high and low halves), so twice the FLOPs at 989 TFLOP/s, 494.5
    effective."""
    elt = 4 if dtype == "float32" else 2
    pixels = b * hw * hw
    nbytes = elt * pixels * (cin + cout) + 4 * (9 * cin * cout + cout)
    route = route or ("tensor_core_tf32x3" if dtype == "float32" else "tensor_core")
    flops = 2.0 * pixels * 9 * cin * cout
    return _bound(nbytes, (2 if route == "tensor_core" else 1) * flops, route)


def fused_conv_tolerance(dtype: str, ref_max: float) -> float:
    """B4 vs its plain version, max abs error. fp32: both sum the same fp32
    products in other orders, 1e-5 of the output's magnitude. bf16: both
    round fp32 results that differ by about 1e-6 relative, so an element
    may land one bf16 ulp apart: 2^-7 of the magnitude."""
    return max(1.0, ref_max) * (1e-5 if dtype == "float32" else 2.0 ** -7)


def kernel_phase() -> dict:
    """B1 at every listed shape against its plain version; returns the
    serving shape's rows by type."""
    import torch
    import torch.nn.functional as F
    from twingan_tpu_torch.ops import attention

    results = {}
    for label, b, n, c_bar, c, dtype in KERNEL_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        f = torch.randn(b, n, c_bar, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, n, c_bar, device="cuda", generator=gen).to(dt)
        h = torch.randn(b, n, c, device="cuda", generator=gen).to(dt)
        want = expected_variant(attention.KERNEL_NAME, dt, c_bar, c)
        attention.reset_launch_counts()
        o, lse = attention.flash_attention_forward(f, g, h)
        torch.cuda.synchronize()
        variant = ran_variants(attention.KERNEL_NAME)
        ref = attention.attention_core(f, g, h)
        ref_lse = attention.attention_lse(f, g)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = tolerance(dtype, ref_max)
        lse_tol = 1e-4 * max(1.0, ref_lse.abs().max().item())
        q, k, v = f[:, None], g[:, None], h[:, None]
        sdpa_err = (F.scaled_dot_product_attention(q, k, v, scale=1.0)[:, 0].float()
                    - ref.float()).abs().max().item()
        ms = time_ms(lambda: attention.flash_attention_forward(f, g, h))
        dev_ms = device_ms(lambda: attention.flash_attention_forward(f, g, h))
        plain_ms = time_ms(lambda: attention.attention_core(f, g, h))
        # Past the register-held widths, the plain version's device time too
        # (its events time one call's host dispatch as well).
        wide = c_bar > 64 or c > 256
        plain_dev = device_ms(lambda: attention.attention_core(f, g, h)) if wide else None
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
        bound_ms, bound_by = bound(b, n, c_bar, c, dtype, want)
        row = {"phase": "kernel", "case": label, "B": b, "N": n, "c_bar": c_bar, "C": c,
               "dtype": dtype, "variant": variant, "max_abs_err": err, "tolerance": tol,
               "lse_err": lse_err, "lse_tolerance": lse_tol, "sdpa_err": sdpa_err, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               **({"plain_device_ms": plain_dev} if wide else {}),
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by,
               **({"bound_ms_by_route": {r: bound(b, n, c_bar, c, dtype, r)[0]
                                         for r in FP32_ROUTES}} if dtype == "float32" else {}),
               "ok": bool(err <= tol and lse_err <= lse_tol and variant == [want])}
        emit(row)
        if not row["ok"]:
            fail("kernel", f"flash_attn_fwd disagrees with the plain version at {label} "
                           f"B={b} N={n} c_bar={c_bar} C={c} {dtype}")
        results[(label, b, n, c_bar, c, dtype)] = row
    MEASURED["flash_attn_fwd_wide"] = [wide_row(r) for r in results.values()
                                       if r["c_bar"] > 64 or r["C"] > 256]
    return {case[-1]: results[case] for case in (SERVING_CASE, FP32_SERVING_CASE)}


def eager_conv_chain(x, w, b):
    """What the grad route runs for one step: cuDNN's conv on x's type, the
    bias, leaky and pixel norm as separate kernels (as ConvBlock +
    pixel_norm, with the eq-lr scale already in w)."""
    import torch.nn.functional as F
    from twingan_tpu_torch.ops import basic

    y = F.conv2d(x, w.to(x.dtype), padding=1) + b.to(x.dtype)[:, None, None]
    return basic.pixel_norm(basic.leaky_relu(y), dim=1)


def cudnn_best_ms(x, w) -> float:
    """cuDNN's conv at its best: benchmark mode (it times its algorithms on
    the first calls) and channels-last x and w. Both settings are restored,
    so that no later phase runs under them."""
    import torch
    import torch.nn.functional as F

    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        x_cl = x.contiguous(memory_format=torch.channels_last)
        w_cl = w.contiguous(memory_format=torch.channels_last)
        return time_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
    finally:
        torch.backends.cudnn.benchmark = before


def fused_conv_phase() -> dict:
    """B4 at every listed shape against its plain version; returns the rows
    of the generator's layers by type."""
    import torch
    import torch.nn.functional as F
    from twingan_tpu_torch.ops import fused_conv

    rows = []
    for label, b, hw, cin, cout, dtype, per_pass in FUSED_CONV_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        x = torch.randn(b, cin, hw, hw, device="cuda", generator=gen).to(dt)
        kernel = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
        w9 = fused_conv.fold_weights(kernel, (2.0 / (cin * 9)) ** 0.5)
        bias = 0.2 * torch.randn(cout, device="cuda", generator=gen)
        fused_conv.reset_launch_counts()
        y = fused_conv.fused_conv(x, w9, bias)
        torch.cuda.synchronize()
        variant = [k.split("/", 1)[1] for k, v in fused_conv.variant_counts.items() if v]
        route = [k.split("/", 1)[1] for k, v in fused_conv.route_counts.items() if v]
        want_route = (fused_conv.TWO_PASS if cout > fused_conv.ONE_PASS_WIDTH
                      else fused_conv.ONE_PASS).split("/", 1)[1]
        ref = fused_conv.fused_conv_plain(x, w9, bias)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = fused_conv_tolerance(dtype, ref_max)
        w = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        w_lib = w.to(dt)
        bound_ms, bound_by = fused_conv_bound(b, hw, cin, cout, dtype)
        row = {"phase": "kernel", "kernel": "fused_conv", "case": label, "B": b, "H": hw,
               "W": hw, "Cin": cin, "Cout": cout, "dtype": dtype, "layers_per_pass": per_pass,
               "variant": variant, "route": route, "max_abs_err": err, "tolerance": tol,
               "shape_ok": tuple(y.shape) == (b, cout, hw, hw) and y.dtype == dt,
               "finite": bool(torch.isfinite(y).all()),
               "ms": time_ms(lambda: fused_conv.fused_conv(x, w9, bias)),
               "device_ms": device_ms(lambda: fused_conv.fused_conv(x, w9, bias)),
               "plain_ms": time_ms(lambda: fused_conv.fused_conv_plain(x, w9, bias)),
               "library": "cuDNN F.conv2d alone, weights in x's type (no single PyTorch "
                          "call computes conv + bias + leaky + pixel norm)",
               "library_ms": time_ms(lambda: F.conv2d(x, w_lib, padding=1)),
               "library_best": "cuDNN F.conv2d alone, cudnn.benchmark on, x and weights "
                               "channels-last in x's type",
               "library_best_ms": cudnn_best_ms(x, w_lib),
               "eager_chain_ms": time_ms(lambda: eager_conv_chain(x, w, bias)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               **({"bound_ms_by_route": {r: fused_conv_bound(b, hw, cin, cout, dtype, r)[0]
                                         for r in FP32_ROUTES}} if dtype == "float32" else {})}
        row["ok"] = bool(err <= tol and row["shape_ok"] and row["finite"]
                         and variant == [fused_conv.VARIANTS[dt]] and route == [want_route])
        emit(row)
        if not row["ok"]:
            fail("kernel", f"fused_conv disagrees with the plain version, or ran another "
                           f"variant than {fused_conv.VARIANTS[dt]} or another route than "
                           f"{want_route}, at {label} B={b} H=W={hw} {cin}->{cout} {dtype}")
        rows.append(row)
        del x, kernel, w9, bias, y, ref, w, w_lib
        torch.cuda.empty_cache()
    MEASURED["fused_conv_wide"] = [wide_row(r) for r in rows if r["Cout"] > fused_conv.COUT_TILE]
    return {dtype: [r for r in rows if r["layers_per_pass"] and r["dtype"] == dtype]
            for dtype in ("bfloat16", "float32")}


WIDE_ROW_KEYS = ("case", "dtype", "B", "N", "c_bar", "C", "H", "Cin", "Cout", "variant", "route",
                 "max_abs_err", "tolerance", "device_ms", "bound_ms", "bound_by", "plain_ms",
                 "plain_device_ms", "library_ms", "library_best_ms")


def wide_row(row: dict) -> dict:
    """The numbers of a kernel row past the register-held widths (or past
    one block's 1024 channels) that the kernels line repeats."""
    return {k: row[k] for k in WIDE_ROW_KEYS if k in row}


def sdpa_backend(q, k, v, do):
    """The first of SDPA_BACKENDS that runs forward and backward on these
    inputs (q/k and v differ in head width, which not every backend takes)."""
    import warnings

    import torch
    from torch.nn import functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns with its reason
                torch.autograd.grad(F.scaled_dot_product_attention(q, k, v, scale=1.0),
                                    (q, k, v), do)
            torch.cuda.synchronize()
            return name, backend
        except RuntimeError:
            continue
    fail("kernel", "no SDPA backend runs these inputs")


def backward_kernel_phase() -> dict:
    """B2 and B3 at every listed shape; returns the training shape's rows
    by type.
    At N above PLAIN_MAX_N the reference is ``chunked_reference``, which
    also checks the forward kernel's output and logsumexp there."""
    import torch
    from torch.nn import functional as F
    from torch.nn.attention import sdpa_kernel
    from twingan_tpu_torch.ops import attention

    results = {}
    for label, b, n, c_bar, c, dtype in BWD_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        f, g = (torch.randn(b, n, c_bar, device="cuda", generator=gen).to(dt) for _ in range(2))
        h, do = (torch.randn(b, n, c, device="cuda", generator=gen).to(dt) for _ in range(2))
        chunked = n > PLAIN_MAX_N
        reps = 3 if chunked else 20
        leaves = [t.clone().requires_grad_(True) for t in (f, g, h)]
        attention.reset_launch_counts()
        grads = torch.autograd.grad(attention.flash_attention_core(*leaves), leaves, do)
        variants = {k_: ran_variants(k_) for k_ in (attention.DQ_KERNEL, attention.DKV_KERNEL)}
        errs, tols, extra = {}, {}, {}
        if chunked:
            ref_o, ref_lse, *refs = chunked_reference(f, g, h, do)
            o, lse = attention.flash_attention_forward(f, g, h)
            extra = {"reference": f"chunked over {REFERENCE_ROWS} query rows",
                     "forward_err": (o.float() - ref_o).abs().max().item(),
                     "forward_tolerance": tolerance(dtype, ref_o.abs().max().item()),
                     "lse_err": (lse - ref_lse).abs().max().item(),
                     "lse_tolerance": 1e-4 * max(1.0, ref_lse.abs().max().item())}
            del o, lse, ref_o, ref_lse
        else:
            ref_leaves = [t.float().requires_grad_(True) for t in (f, g, h)]
            refs = torch.autograd.grad(attention.attention_core(*ref_leaves), ref_leaves,
                                       do.float())
            del ref_leaves
        torch.cuda.synchronize()
        for name, out, ref in zip(("df", "dg", "dh"), grads, refs):
            errs[name] = (out.float() - ref).abs().max().item()
            tols[name] = grad_tolerance(dtype, ref.abs().max().item(), n)
        del grads, refs, leaves
        torch.cuda.empty_cache()

        o, lse = attention.flash_attention_forward(f, g, h)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (f, g, h, do, lse, delta)
        ms = {"flash_attn_dq": time_ms(lambda: attention.flash_attention_dq(*args), reps),
              "flash_attn_dkv": time_ms(lambda: attention.flash_attention_dkv(*args), reps)}
        dev_ms = {"flash_attn_dq": device_ms(lambda: attention.flash_attention_dq(*args), reps),
                  "flash_attn_dkv": device_ms(lambda: attention.flash_attention_dkv(*args),
                                              reps)}
        plain_ms = None if chunked else {
            "flash_attn_dq": time_ms(lambda: attention.flash_attention_dq_plain(*args)),
            "flash_attn_dkv": time_ms(lambda: attention.flash_attention_dkv_plain(*args))}
        wide = c_bar > 64 or c > 256  # there, the plain versions' device time too
        plain_dev = {
            "flash_attn_dq": device_ms(lambda: attention.flash_attention_dq_plain(*args)),
            "flash_attn_dkv": device_ms(lambda: attention.flash_attention_dkv_plain(*args))
        } if wide and not chunked else None
        q, k, v = (t[:, None].detach().requires_grad_(True) for t in (f, g, h))
        backend_name, backend = sdpa_backend(q, k, v, do[:, None])
        with sdpa_kernel(backend):
            library_ms = time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q, k, v, scale=1.0), (q, k, v), do[:, None]),
                reps)
        want = {k_: expected_variant(k_, dt, c_bar, c) for k_ in variants}
        bounds = bwd_bounds(b, n, c_bar, c, dtype, want)
        row = {"phase": "kernel", "kernels": ["flash_attn_dq", "flash_attn_dkv"], "case": label,
               "B": b, "N": n, "c_bar": c_bar, "C": c, "dtype": dtype, "variant": variants,
               "max_abs_err": errs, "tolerance": tols, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, **({"plain_device_ms": plain_dev} if plain_dev else {}),
               "library": f"SDPA forward + backward, scale 1.0, {backend_name} backend",
               "library_ms": library_ms,
               "bound_ms": {k_: v_[0] for k_, v_ in bounds.items()},
               "bound_by": {k_: v_[1] for k_, v_ in bounds.items()}, **extra,
               **({"bound_ms_by_route": {
                   r: {k_: v_[0] for k_, v_ in bwd_bounds(
                       b, n, c_bar, c, dtype, dict.fromkeys(want, r)).items()}
                   for r in FP32_ROUTES}} if dtype == "float32" else {}),
               "ok": bool(all(errs[k_] <= tols[k_] for k_ in errs)
                          and all(v_ == [want[k_]] for k_, v_ in variants.items())
                          and (not chunked or (extra["forward_err"] <= extra["forward_tolerance"]
                                               and extra["lse_err"] <= extra["lse_tolerance"])))}
        emit(row)
        if not row["ok"]:
            fail("kernel", f"flash backward disagrees with autograd of the plain version at "
                           f"{label} B={b} N={n} c_bar={c_bar} C={c} {dtype}")
        results[(label, b, n, c_bar, c, dtype)] = row
        del o, lse, delta, args, q, k, v
        torch.cuda.empty_cache()
    wide = [r for r in results.values() if r["c_bar"] > 64 or r["C"] > 256]
    for name in ("flash_attn_dq", "flash_attn_dkv"):
        MEASURED[f"{name}_wide"] = [
            {**wide_row({k: (v[name] if isinstance(v, dict) and name in v else v)
                         for k, v in r.items()}),
             "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"]} for r in wide]
    return {case[-1]: results[case] for case in (TRAIN_CASE, FP32_TRAIN_CASE)}


def slice_config():
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig

    return TwinGANConfig(
        model=PGGANConfig(resolution=256, max_channels=256, norm_type="batch_norm",
                          equalized_lr=True, do_pixel_norm=True, num_domains=2,
                          dtype="bfloat16", do_self_attention=True, self_attention_hw=64),
        use_unet=True)


def random_translator(cfg):
    """Seeded random weights in which attention and the norms show: every
    sa_gamma 1, norm banks and moving statistics drawn at random, and the
    target-domain bank of the output layer set to put images in [0,1] as a
    trained model's are (0.5 + 0.05 * normalized)."""
    import torch
    from twingan_tpu_torch.models.layers import DomainNorm, SelfAttention, reset_parameters
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTranslator

    gen = torch.Generator().manual_seed(SEED)
    model = TwinGANTranslator(cfg)
    reset_parameters(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SelfAttention):
                m.sa_gamma.fill_(1.0)
            if isinstance(m, DomainNorm) and m.kind == "batch_norm":
                for name, t in list(m.named_parameters()) + list(m.named_buffers()):
                    if name.startswith(("gamma_", "moving_var_")):
                        t.uniform_(0.5, 1.5, generator=gen)
                    else:
                        t.normal_(0.0, 0.2, generator=gen)
        out_norm = getattr(model.generator, f"to_rgb_{cfg.model.resolution}").norm
        out_norm.gamma_1.fill_(0.05)
        out_norm.beta_1.fill_(0.5)
    return model


def serving_phase(card: str, smi_line: str, dtype: str = "bfloat16") -> int:
    """The slice config served in ``dtype`` (its own bf16, or the JAX
    package's default fp32) against fp32 on the CPU; B1 must run on the
    variant of ``dtype`` only. Returns the forward kernel's launches."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.ops import attention
    from twingan_tpu_torch.runner.checkpoint import save_stage
    from twingan_tpu_torch.serve.clients import BatchingLocalClient

    cfg = slice_config()
    stage_dir = tempfile.mkdtemp(prefix="twingan_smoke_")
    try:
        model = random_translator(cfg)
        save_stage(stage_dir, cfg, model.state_dict(), step=0)
        rng = np.random.RandomState(SEED)
        images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
                  for _ in range(REQUESTS_PER_ROUND)]

        inferer = ImageInferer(stage_dir, dtype=dtype)  # the card, by default
        client = BatchingLocalClient(inferer, max_batch=4, max_wait_ms=50.0)
        attention.reset_launch_counts()
        round_s = []
        try:
            with ThreadPoolExecutor(REQUESTS_PER_ROUND) as pool:
                for _ in range(1 + TIMED_ROUNDS):  # the first round warms up
                    t0 = time.perf_counter()
                    outs = list(pool.map(client.do_inference, images))
                    torch.cuda.synchronize()
                    round_s.append(time.perf_counter() - t0)
        finally:
            client.close()
        launches = attention.launch_counts[attention.KERNEL_NAME]
        variants = dict(attention.variant_counts)
        dispatches = client.dispatches

        for i, out in enumerate(outs):
            if out.shape != (256, 256, 3) or not np.isfinite(out).all():
                fail("serving", f"request {i}: shape {out.shape}, finite {np.isfinite(out).all()}")
            if out.min() < 0.0 or out.max() > 1.0:
                fail("serving", f"request {i}: values in [{out.min()}, {out.max()}], not [0,1]")
        if launches != 2 * dispatches or dispatches < 2 * (1 + TIMED_ROUNDS):
            fail("serving", f"{launches} kernel launches for {dispatches} dispatched batches "
                            "(expected 2 per batch: encoder and generator)")
        fwd = attention.KERNEL_NAME
        want = f"{fwd}/{attention.VARIANTS[fwd][getattr(torch, dtype)]}"
        if variants[want] != launches or sum(variants.values()) != launches:
            fail("serving", f"{dtype} serving launched other variants than {want}: {variants}")

        cpu = ImageInferer(stage_dir, device="cpu", dtype="float32")
        ref = cpu.infer_batch([images[0]])[0]
        std = float(ref.std())
        diff = np.abs(outs[0] - ref)
        mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
        mean_tol, max_tol = SERVE_TOLS[dtype]
        tf32, tf32_ok = {}, True
        if dtype == "float32":
            # The same request with TF32 products in cuDNN and the matmuls.
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                t = np.abs(inferer.infer_batch([images[0]])[0] - ref)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            tf32 = {"tf32_mean_abs_err_over_std": float(t.mean()) / std,
                    "tf32_max_abs_err_over_std": float(t.max()) / std}
            tf32_ok = (tf32["tf32_mean_abs_err_over_std"] > mean_tol
                       and tf32["tf32_max_abs_err_over_std"] > max_tol)
        with torch.no_grad():
            for m in cpu.model.modules():
                if hasattr(m, "sa_gamma"):
                    m.sa_gamma.zero_()
        no_attention = float(np.abs(cpu.infer_batch([images[0]])[0] - ref).mean()) / std
        timed = sorted(round_s[1:])[len(round_s[1:]) // 2]
        MEASURED[f"serving_images_per_s_{dtype}"] = REQUESTS_PER_ROUND / timed
        row = {"phase": "serving", "dtype": dtype,
               "requests": REQUESTS_PER_ROUND * (1 + TIMED_ROUNDS),
               "dispatches": dispatches, "kernel_launches": launches,
               "kernel_variants": {k: v for k, v in variants.items() if v},
               "images_per_s": REQUESTS_PER_ROUND / timed, "round_s": round_s,
               "card": card, "nvidia_smi": smi_line,
               "vs_cpu_fp32": {"mean_abs_err_over_std": mean_err, "max_abs_err_over_std": max_err,
                               "mean_tolerance": mean_tol, "max_tolerance": max_tol,
                               "output_std": std,
                               "attention_off_mean_diff_over_std": no_attention, **tf32},
               "ok": bool(mean_err <= mean_tol and max_err <= max_tol
                          and no_attention > mean_tol and tf32_ok)}
        emit(row)
        if not row["ok"]:
            fail("serving", "the card's output disagrees with the fp32 CPU run, attention "
                            "does not change the output beyond the tolerance, or TF32 "
                            "products stay within the fp32 tolerances")
        return launches
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)


def http_request(url: str, data=None, ctype=None, timeout: float = 120.0):
    """(status, body) of a GET (data None) or POST to the phase's server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_body(form: str, png: bytes):
    """The faces image as one of the server's upload forms: (body, type)."""
    import base64

    if form == "raw":
        return png, "image/png"
    if form == "base64":
        return json.dumps({"image": base64.b64encode(png).decode()}).encode(), "application/json"
    boundary = "----chipsmoke"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"faces.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
    return body + png + f"\r\n--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def http_phase(card: str, smi_line: str) -> int:
    """The serving front door: the port's server (``serve/server.py``, built
    by ``build_service`` as its command line builds it) answering POSTs
    through a real socket. Returns B1's launches."""
    import numpy as np
    import torch
    from twingan_tpu_torch.data.png import decode_png
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.ops import attention
    from twingan_tpu_torch.runner.checkpoint import save_stage
    from twingan_tpu_torch.serve import server
    from twingan_tpu_torch.serve.face_detection import FaceDetector
    from http.server import ThreadingHTTPServer

    t_phase = time.perf_counter()
    with open(os.path.join(REPO, HTTP_FACES), "rb") as f:
        png = f.read()
    image = decode_png(png)
    crops = FaceDetector(max_faces=HTTP_MAX_FACES).crop_faces(image)  # in-process
    try:
        import PIL
        pil_version = PIL.__version__
    except ImportError:
        pil_version = None

    cfg = slice_config()
    root = tempfile.mkdtemp(prefix="twingan_smoke_http_")
    service = httpd = None
    writes: list = []
    real_imsave = server.imsave_float
    try:
        save_stage(root, cfg, random_translator(cfg).state_dict(), step=0)
        args = server.parse_args([f"--model_path={root}",
                                  f"--output_dir={os.path.join(root, 'outputs')}",
                                  f"--serve_batch={HTTP_SERVE_BATCH}",
                                  f"--detector_procs={HTTP_DETECTOR_PROCS}",
                                  f"--max_faces={HTTP_MAX_FACES}"])
        service = server.build_service(args)  # the card, by default

        # Where a request's time goes: detection, translation and the writes
        # it queues, per handler thread; the writer thread's PNG encodes.
        local = threading.local()

        def timed(fn, key):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    local.parts[key] += time.perf_counter() - t0
            return wrapper

        parts: list = []
        handle = service.handle_image

        def handle_timed(img):
            local.parts = {"detect_s": 0.0, "translate_s": 0.0, "write_s": 0.0}
            out = handle(img)
            parts.append(local.parts)
            return out

        def imsave_timed(*a, **kw):
            t0 = time.perf_counter()
            real_imsave(*a, **kw)
            writes.append(time.perf_counter() - t0)

        service.detector.crop_faces = timed(service.detector.crop_faces, "detect_s")
        service.client.do_inference = timed(service.client.do_inference, "translate_s")
        service._save = timed(service._save, "write_s")
        service.handle_image = handle_timed
        server.imsave_float = imsave_timed
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(service))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(i):
            body, ctype = http_body(HTTP_FORMS[i % len(HTTP_FORMS)], png)
            t0 = time.perf_counter()
            code, data = http_request(url, body, ctype)
            return code, data, time.perf_counter() - t0

        attention.reset_launch_counts()
        rounds = []
        with ThreadPoolExecutor(HTTP_REQUESTS) as pool:
            for _ in range(2):  # a warm-up round, then the timed one
                del parts[:]
                t0 = time.perf_counter()
                answers = list(pool.map(post, range(HTTP_REQUESTS)))
                rounds.append((time.perf_counter() - t0, answers, list(parts)))
        torch.cuda.synchronize()
        launches = attention.launch_counts[attention.KERNEL_NAME]
        variants = {k: v for k, v in attention.variant_counts.items() if v}
        dispatches = service.client.dispatches

        # Every answer, and every output fetched back through the socket.
        cpu = ImageInferer(root, device="cpu", dtype="float32")
        ref = cpu.infer_batch(crops)
        std = float(ref.std())
        ref_png = np.clip(ref * 255.0, 0, 255).astype(np.uint8)
        mean_err = max_err = 0.0
        problems = []
        for r, (_, answers, _) in enumerate(rounds):
            for i, (code, data, _) in enumerate(answers):
                answer = json.loads(data) if code == 200 else {}
                if answer.get("status") != "success" or answer["num_faces"] != len(crops):
                    problems.append(f"round {r} request {i}: {code} {data[:200]!r}")
                    continue
                for k, out in enumerate(answer["outputs"]):
                    c1, combined = http_request(url + out["combined"])
                    c2, translated = http_request(url + out["translated"])
                    if c1 != 200 or c2 != 200:
                        problems.append(f"round {r} request {i} face {k}: GET {c1} {c2}")
                        continue
                    combined, translated = decode_png(combined), decode_png(translated)
                    hw = cfg.model.resolution
                    if combined.shape != (hw, 2 * hw, 3) or translated.shape != (hw, hw, 3):
                        problems.append(f"round {r} request {i} face {k}: shapes "
                                        f"{combined.shape} {translated.shape}")
                        continue
                    diff = np.abs(translated.astype(np.float32) - ref_png[k]) / 255.0
                    mean_err = max(mean_err, float(diff.mean()) / std)
                    max_err = max(max_err, float(diff.max()) / std)
        preview = "not posted: PIL is missing here, and the preview's label text needs it"
        if pil_version:
            import base64

            body = json.dumps({"image": base64.b64encode(png).decode(),
                               "detect_face": True}).encode()
            code, data = http_request(url, body, "application/json")
            preview = {"status": code, "face_found": code == 200 and json.loads(data)["face_found"]}
            if preview != {"status": 200, "face_found": True}:
                problems.append(f"detect_face preview: {code} {data[:200]!r}")
        service.writer.join()

        wall, answers, timed_parts = rounds[1]
        latencies = sorted(t for _, _, t in answers)
        faces = sum(json.loads(d)["num_faces"] for c, d, _ in answers if c == 200)
        fwd_tc = f"{attention.KERNEL_NAME}/{attention.TENSOR_CORE}"
        pct = lambda q: latencies[min(len(latencies) - 1, int(q * len(latencies)))]  # noqa: E731
        row = {"phase": "http", "requests": HTTP_REQUESTS * len(rounds),
               "forms": list(HTTP_FORMS), "faces_per_request": len(crops),
               "dispatches": dispatches, "kernel_launches": launches,
               "kernel_variants": variants,
               "timed_round": {"seconds": wall, "faces_per_s": faces / wall,
                               "latency_p50_s": pct(0.5), "latency_p90_s": pct(0.9),
                               "latency_max_s": latencies[-1],
                               "mean_detect_s": statistics.mean(p["detect_s"] for p in timed_parts),
                               "mean_translate_s": statistics.mean(p["translate_s"]
                                                                   for p in timed_parts),
                               "mean_write_s": statistics.mean(p["write_s"] for p in timed_parts)},
               "warmup_round_s": rounds[0][0],
               "png_write_ms_per_image": 1e3 * statistics.mean(writes),
               "pil": pil_version, "detect_face_preview": preview,
               "vs_cpu_fp32": {"mean_abs_err_over_std": mean_err,
                               "max_abs_err_over_std": max_err, "output_std": std,
                               "mean_tolerance": SERVE_MEAN_TOL, "max_tolerance": SERVE_MAX_TOL,
                               "compared": "each translated face's PNG against the fp32 CPU "
                                           "output of the same crop, written to 8 bits alike"},
               "seconds": time.perf_counter() - t_phase, "card": card, "nvidia_smi": smi_line,
               "problems": problems[:10]}
        row["ok"] = bool(not problems and launches == 2 * dispatches and dispatches >= 1
                         and variants == {fwd_tc: launches}
                         and mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL)
        emit(row)
        if not row["ok"]:
            fail("http", "the server's answers, its outputs, B1's launches (2 a dispatched "
                         "batch, all tensor-core) or its faces against the fp32 CPU run")
        return launches
    finally:
        server.imsave_float = real_imsave
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if service is not None:
            service.client.close()
            service.detector.close()
        shutil.rmtree(root, ignore_errors=True)


class GradRecorder:
    """Stands in for one side's optimizer for one step: keeps the gradients
    it is handed (on the CPU, fp32), then lets the optimizer step."""

    def __init__(self, inner):
        self.inner, self.names, self.params = inner, inner.names, inner.params
        self.grads = None

    def step(self, grads):
        self.grads = {n: g.detach().float().cpu() for n, g in zip(self.names, grads)}
        self.inner.step(grads)


def train_config(base=None):
    """The serving slice's configuration (so trained weights load into
    ImageInferer unchanged) with the training defaults of the JAX package:
    DRAGAN, Adam, n_critic 2; fuse_passes auto (off for batch norm)."""
    return (base or slice_config()).replace(batch_size=TRAIN_BATCH)


def set_attention_gamma(nets, value: float = 1.0) -> None:
    """At its init value 0, sa_gamma would zero the gradients into the
    attention projections, and a wrong backward kernel could not show."""
    import torch
    from twingan_tpu_torch.models.layers import SelfAttention

    with torch.no_grad():
        for m in nets.modules():
            if isinstance(m, SelfAttention):
                m.sa_gamma.fill_(value)


def expected_launches(trainer, nets) -> dict:
    """Kernel launches per G step and per D step, from the step's passes:
    each pass of a network with self-attention runs the forward kernel
    once, and dq and dkv once if the pass is differentiated.
    G step: 4 encoder passes (enc(s), enc(t), the two prime re-encodes),
    with the style embedding 4 style-encoder passes (the same images), 4
    generator passes (2 when fused), the discriminator on prime and cycle
    per domain (one pass per domain when fused), all differentiated.
    D step: enc(s), enc(t) (and the two style passes) and the generator
    passes under no_grad; the discriminator on real, prime and cycle per
    domain (one pass per domain when fused), differentiated; the two
    gradient-penalty passes on the plain route. Under remat every
    differentiated pass runs its forward again in the backward (2 forward
    launches, 1 dq, 1 dkv), and a penalty pass twice more (its first
    backward, taken with create_graph, and the second-order one)."""
    from twingan_tpu_torch.models.layers import SelfAttention
    from twingan_tpu_torch.ops import attention
    from twingan_tpu_torch.train.twingan_trainer import DIS_S, ENC, ENC_STYLE, GEN

    cfg = trainer.cfg
    sa = {k: sum(isinstance(m, SelfAttention) for m in nets[k].modules())
          for k in (ENC, GEN, DIS_S, ENC_STYLE) if k in nets}
    style = sa.get(ENC_STYLE, 0)
    kinds = 2 if (cfg.model.resolution >= 64 and cfg.do_l_cyc_gan) else 1
    gen_passes = 2 if cfg.fuse else 4
    g_dis = 2 if cfg.fuse else 2 * kinds
    d_dis = 2 if cfg.fuse else 2 * (1 + kinds)
    g = 4 * sa[ENC] + 4 * style + gen_passes * sa[GEN] + g_dis * sa[DIS_S]
    d = d_dis * sa[DIS_S]
    d_light = 2 * sa[ENC] + 2 * style + gen_passes * sa[GEN]
    twice, penalty = (2, 3) if cfg.remat else (1, 1)
    fwd, dq, dkv = attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL
    return {"g_step": {fwd: twice * g, dq: g, dkv: g, attention.PLAIN_ROUTE: 0},
            "d_step": {fwd: d_light + twice * d, dq: d, dkv: d,
                       attention.PLAIN_ROUTE: penalty * 2 * sa[DIS_S]}}


def _cosine(a, b) -> float:
    """In float64: fp32 sums over millions of elements are off by more than
    the differences the limits look for."""
    import torch

    a, b = a.double(), b.double()
    return float(torch.dot(a, b) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))


def _held_leaf(key: str, held_buffers) -> bool:
    """``key``'s leaf is one of ``held_buffers``: the same name, or a name
    the entry ending in ``_`` starts (``renorm_`` for every renorm EMA)."""
    leaf = key.rsplit(".", 1)[-1]
    return any(leaf == pat or (pat.endswith("_") and leaf.startswith(pat))
               for pat in held_buffers)


def compare_steps(cfg, weights, batches, gp_noise, card: str = "cuda", trainer_cls=None,
                  zs=None, phase: str = "train", limits=None, grad_prefix=None,
                  b4_steps=(), step: int = 0, held_buffers=None, gdrop_strength: float = 0.0,
                  step_kw=None, kinds=("g_step", "d_step"), check_updates: bool = False,
                  zero_grads=None) -> list:
    """One G step and one D step, each from ``weights``, on the ``card`` in
    float32 and in bfloat16 against the same steps in fp32 on the CPU (plain
    attention), within ``limits`` (TRAIN_LIMITS by default). ``trainer_cls``
    is TwinGANTrainer (the default) or GanTrainer, whose steps also take the
    generator's noise ``zs[kind]``. ``grad_prefix[kind]`` is put before the
    names of the step's optimizer, where they do not start with the
    network's name. On the card, each step launches only the variants of
    its type: the three attention kernels where the networks have
    attention, and B4 in the steps named in ``b4_steps`` and in no other.
    Each step starts at global ``step`` with gdrop strength
    ``gdrop_strength``; ``step_kw[kind]`` holds more arguments of the step
    (the random style and gdrop draws, on the CPU, that both sides take).
    ``kinds`` names the steps to run (``batches`` has one batch each).
    ``held_buffers`` maps buffer leaves (``renorm_``, ``u``) to the
    absolute limit their values after the step are held to against the
    CPU's, elementwise; None holds them to the step's loss limits (rtol *
    |cpu| + atol). With ``check_updates`` the optimizer's update of each
    network (parameters after the step minus before) is held to the
    gradients' cosine limit too. ``zero_grads[kind]`` names the modules
    whose gradient in that step is 0 in exact arithmetic: each is held by
    its largest absolute difference from the CPU's (at most
    ``ZERO_GRAD_ATOL``) instead of a cosine, since such a gradient is
    rounding noise on both sides, and the cosine of two noises says
    nothing.
    Returns one row per step and card type."""
    import torch
    from twingan_tpu_torch.models.layers import SelfAttention
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    trainer_cls = trainer_cls or TwinGANTrainer
    limits = limits or TRAIN_LIMITS
    grad_prefix = grad_prefix or {}

    held_buffers = held_buffers or {}

    def run(trainer, kind, batch):
        state = trainer.state_from_nets(trainer.build_nets(), step=step, critic_step=1)
        state.nets.load_state_dict(weights)
        state.gdrop_strength = torch.tensor(gdrop_strength, device=trainer.device)
        side = "gen_opt" if kind == "g_step" else "dis_opt"
        recorder = GradRecorder(getattr(state, side))
        setattr(state, side, recorder)
        before = [p.detach().float().cpu().clone() for p in recorder.params]
        kw = {} if zs is None else {"z": zs[kind]}
        kw.update((step_kw or {}).get(kind, {}))
        attention.reset_launch_counts()
        fused_conv.reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "g_step":
            _, metrics = trainer.g_step(state, batch, **kw)
        else:
            _, metrics = trainer.d_step(state, batch, gp_noise=gp_noise, **kw)
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        sa_widths = {n: m.sa_h.conv.in_channels for n, m in state.nets.named_modules()
                     if isinstance(m, SelfAttention)}
        prefix = grad_prefix.get(kind, "")
        grads = {prefix + n: g for n, g in getattr(state, side).grads.items()}
        buffers = {k: v.detach().float().cpu() for k, v in state.nets.state_dict().items()
                   if _held_leaf(k, held_buffers)}
        updates = {prefix + n: p.detach().float().cpu() - b
                   for n, p, b in zip(recorder.names, recorder.params, before)}
        return metrics, grads, seconds, sa_widths, buffers, updates

    def flat(grads, prefix):
        return torch.cat([g.flatten() for n, g in grads.items() if n.startswith(prefix + ".")])

    def on(device, dtype):
        return trainer_cls(cfg.replace(model=cfg.model.replace(dtype=dtype)), device=device)

    rows = []
    ref_trainer = on("cpu", "float32")
    for kind, batch in zip(kinds, batches):
        ref_m, ref_grads, cpu_s, _, ref_buffers, ref_updates = run(ref_trainer, kind, batch)
        for dtype, (rtol, atol, min_cos, min_sa_cos) in limits.items():
            m, grads, card_s, sa_widths, buffers, updates = run(on(card, dtype), kind, batch)
            sa_names = list(sa_widths)
            # The kernels run the variants of the step's type at its
            # attention widths only (on the CPU, none runs).
            dt = getattr(torch, dtype)
            variants = {k: v for counts in (attention.variant_counts, fused_conv.variant_counts)
                        for k, v in counts.items() if v}
            attn = {f"{k}/{expected_variant(k, dt, max(c // 8, 1), c)}"
                    for c in sa_widths.values()
                    for k in (attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL)}
            b4 = ({f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[dt]}"} if kind in b4_steps
                  else set())
            other = [k for k in variants if k not in attn | b4]
            want = (attn if sa_names else set()) | b4
            on_card = torch.device(card).type == "cuda"
            loss_err = {k: abs(m[k] - ref_m[k]) for k in ref_m
                        if k not in ("alpha", "gdrop_strength")}
            networks = sorted({n.split(".", 1)[0] for n in grads})
            zero = (zero_grads or {}).get(kind, ())
            zero_err = {net: {"cpu_max_abs": float(flat(ref_grads, net).abs().max()),
                              "max_abs_diff": float((flat(grads, net)
                                                     - flat(ref_grads, net)).abs().max()),
                              "limit": ZERO_GRAD_ATOL}
                        for net in zero}
            net_cos = {net: _cosine(flat(grads, net), flat(ref_grads, net)) for net in networks
                       if net not in zero}
            update_cos = ({net: _cosine(flat(updates, net), flat(ref_updates, net))
                           for net in networks} if check_updates else {})
            sa_cos = {f"{sa}.{proj}": _cosine(flat(grads, f"{sa}.{proj}"),
                                               flat(ref_grads, f"{sa}.{proj}"))
                      for sa in sa_names if sa.split(".", 1)[0] in networks
                      for proj in ("sa_f", "sa_g", "sa_h")}
            buffer_err, buffers_ok = {}, True
            for pat, limit in held_buffers.items():
                keys = [k for k in ref_buffers if _held_leaf(k, (pat,))]
                errs = [(buffers[k] - ref_buffers[k]).abs() for k in keys]
                bounds = [limit if limit is not None else rtol * ref_buffers[k].abs() + atol
                          for k in keys]
                buffer_err[pat] = {"held": len(keys),
                                   "max_abs_err": max((float(e.max()) for e in errs), default=0.0),
                                   "limit": limit if limit is not None else [rtol, atol]}
                buffers_ok = buffers_ok and bool(keys) and all(
                    bool((e <= b).all()) for e, b in zip(errs, bounds))
            ok = (all(loss_err[k] <= rtol * abs(ref_m[k]) + atol for k in loss_err)
                  and buffers_ok and min(net_cos.values()) >= min_cos
                  and all(v["max_abs_diff"] <= v["limit"] for v in zero_err.values())
                  and all(c >= min_cos for c in update_cos.values())
                  and (min_sa_cos is None or min(sa_cos.values()) >= min_sa_cos)
                  and not other and (not on_card or want <= set(variants)))
            rows.append({"phase": phase, "check": f"{kind}, card {dtype} vs CPU float32",
                         "losses": m, "cpu_losses": ref_m, "loss_abs_err": loss_err,
                         "grad_cosine": net_cos, "attention_projection_grad_cosine": sa_cos,
                         **({"zero_grads": zero_err} if zero else {}),
                         "update_cosine": update_cos,
                         "kernel_variants": variants, "step": step,
                         "buffers_after_step": buffer_err,
                         "limits": {"loss_rtol": rtol, "loss_atol": atol,
                                    "grad_cosine": min_cos, "projection_cosine": min_sa_cos},
                         "card_s": card_s, "cpu_s": cpu_s, "ok": bool(ok)})
    return rows


def _train_batch(rng, cfg, device):
    import torch

    res = cfg.model.resolution
    return {k: torch.from_numpy(rng.rand(TRAIN_BATCH, res, res, 3).astype("float32")).to(device)
            for k in ("source", "target")}


def timed_rounds(trainer, state, rng, card: str, smi_line: str):
    """One warm-up and TRAIN_TIMED_ROUNDS timed rounds of ``trainer`` on the
    card; their kernel launches must be what the passes of the step imply,
    each of the three attention kernels on the variant of the trainer's type
    only. Returns (state, launches by kernel)."""
    import numpy as np
    import torch
    from twingan_tpu_torch.ops import attention

    cfg = trainer.cfg
    dtype = cfg.model.dtype
    rounds = [[_train_batch(rng, cfg, "cuda") for _ in range(cfg.n_critic)]
              for _ in range(1 + TRAIN_TIMED_ROUNDS)]
    state, _ = trainer.round_step(state, rounds[0], rng=SEED)  # warm-up
    torch.cuda.synchronize()
    attention.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    round_s, metrics = [], []
    for batches in rounds[1:]:
        t0 = time.perf_counter()
        state, m = trainer.round_step(state, batches, rng=SEED)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        metrics.append(m)
    counts = dict(attention.launch_counts)
    variants = {k: v for k, v in attention.variant_counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    per_step = expected_launches(trainer, state.nets)
    expected = {k: TRAIN_TIMED_ROUNDS * (per_step["g_step"][k] + (cfg.n_critic - 1)
                                         * per_step["d_step"][k]) for k in counts}
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    expected_variants = {f"{k}/{attention.VARIANTS[k][getattr(torch, dtype)]}": expected[k]
                         for k in (attention.KERNEL_NAME, attention.DQ_KERNEL,
                                   attention.DKV_KERNEL)}
    med = statistics.median(round_s)
    MEASURED[f"train_rounds_per_s_{dtype}"] = 1.0 / med
    MEASURED[f"train_peak_memory_bytes_{dtype}"] = peak
    row = {"phase": "train", "check": "timed rounds", "dtype": dtype,
           "rounds": TRAIN_TIMED_ROUNDS,
           "batch": TRAIN_BATCH, "n_critic": cfg.n_critic, "fused": cfg.fuse,
           "round_s": round_s, "rounds_per_s": 1.0 / med,
           "images_per_s": cfg.n_critic * TRAIN_BATCH / med,
           "timing": "synchronized host clock around each round; images/s counts "
                     "n_critic * batch per round, as tools/train_bench.py does",
           "peak_memory_bytes": peak, "launches": counts, "expected_launches": expected,
           "kernel_variants": variants, "expected_variants": expected_variants,
           "expected_per_step": per_step, "losses": losses, "card": card, "nvidia_smi": smi_line,
           "ok": bool(counts == expected and variants == expected_variants and finite)}
    emit(row)
    if not row["ok"]:
        fail("train", f"the timed {dtype} rounds' launches differ from the passes' count or "
                      f"ran another variant than the {dtype} one, or a loss is not finite")
    return state, counts


def train_phase(card: str, smi_line: str) -> dict:
    """Returns the kernel launches of the timed rounds, by kernel."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.runner.checkpoint import load_model, save_stage
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    cfg = train_config()
    trainer = TwinGANTrainer(cfg)  # the card, by default
    state = trainer.init_state(SEED)
    set_attention_gamma(state.nets)
    weights = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(SEED)
    gen = torch.Generator().manual_seed(SEED)
    res = cfg.model.resolution
    gp_noise = {d: {"alpha": torch.rand(TRAIN_BATCH, 1, 1, 1, generator=gen),
                    "noise": torch.rand(TRAIN_BATCH, res, res, 3, generator=gen) * 2 - 1}
                for d in ("s", "t")}
    for row in compare_steps(cfg, weights, [_train_batch(rng, cfg, "cpu") for _ in range(2)],
                             gp_noise):
        emit(row)
        if not row["ok"]:
            fail("train", f"the card's {row['check']} disagrees beyond the limits")

    state, counts = timed_rounds(trainer, state, rng, card, smi_line)

    stage_dir = tempfile.mkdtemp(prefix="twingan_smoke_train_")
    try:
        save_stage(stage_dir, cfg, trainer.translator_state_dict(state), step=state.step)
        saved, _ = load_model(stage_dir)
        moved = [k for k in saved if "moving_" in k and not torch.equal(saved[k], weights[k])]
        images = [rng.randint(0, 256, (res, res, 3)).astype(np.uint8) for _ in range(TRAIN_BATCH)]
        out = ImageInferer(stage_dir).infer_batch(images)
        row = {"phase": "train", "check": "serve the trained state", "step": state.step,
               "moving_statistics_moved": len(moved),
               "moving_statistics_saved": sum("moving_" in k for k in saved),
               "output_shape": list(out.shape), "finite": bool(np.isfinite(out).all()),
               "ok": bool(out.shape == (TRAIN_BATCH, res, res, 3) and np.isfinite(out).all()
                          and len(moved) == sum("moving_" in k for k in saved) > 0)}
        emit(row)
        if not row["ok"]:
            fail("train", "the trained stage does not serve, or its moving statistics "
                          "are not the ones the rounds updated")
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)
    return counts


def fp32_phase(card: str, smi_line: str) -> dict:
    """The JAX package's default type, fp32, end to end: on the slice
    config, ``serving_phase`` in fp32 (batches of 4 against the CPU's fp32
    inferer, B1 on its fp32 variant only), then one warm-up and
    TRAIN_TIMED_ROUNDS timed fp32 rounds at batch 3 from seeded weights
    (``timed_rounds``: the passes' launches, each kernel on its fp32
    variant only; no B4); then pggan256 generation in fp32
    (``generation_rounds``: a warm-up, GEN_TIMED_ROUNDS timed rounds at
    batch 12 with 13 B4 launches a D step on its fp32 variant, and a
    ``sample`` of 12 against the CPU's fp32). Returns the launches by
    kernel."""
    import numpy as np
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.train.gan_trainer import GanTrainer
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    fused_conv.reset_launch_counts()
    served = serving_phase(card, smi_line, "float32")
    cfg = train_config()
    trainer = TwinGANTrainer(cfg.replace(model=cfg.model.replace(dtype="float32")))
    state = trainer.init_state(SEED)
    set_attention_gamma(state.nets)
    _, counts = timed_rounds(trainer, state, np.random.RandomState(SEED + 20), card, smi_line)
    counts[attention.KERNEL_NAME] += served
    require_no_b4("fp32")
    del trainer, state
    gen_cfg = generation_config()
    gen = GanTrainer(gen_cfg.replace(model=gen_cfg.model.replace(dtype="float32")))
    gen_state = gen.init_state(SEED)
    randomize_biases(gen_state.nets, SEED)
    launches = generation_rounds(card, smi_line, gen, gen_state, "fp32")
    counts[fused_conv.KERNEL_NAME] = launches["rounds"] + launches["sample"]
    return counts


def generation_config(batch: int = GEN_BATCH):
    """pggan256: the PGGAN generation configuration at full width and depth
    (no norm, pixel norm, eq-lr, one domain, bf16), DRAGAN, Adam and
    n_critic 2 at the JAX package's defaults."""
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.train.gan_trainer import GanTrainerConfig

    return GanTrainerConfig(
        model=PGGANConfig(resolution=256, max_channels=256, norm_type="none",
                          do_pixel_norm=True, equalized_lr=True, num_domains=1,
                          dtype="bfloat16"),
        batch_size=batch, n_critic=2)


def spectral_generation_config(batch: int = GEN_BATCH):
    """pggan256 with spectral norm in the discriminator, and without
    equalized lr: a spectral norm makes each kernel's largest singular value
    1, and the eq-lr input scale (0.03 at 256 channels) on top of it shrinks
    every layer 30-fold, so that the discriminator's prediction no longer
    depends on its input (real and fake predictions equal, the generator's
    gradient about 1e-16), a comparison of nothing."""
    cfg = generation_config(batch)
    return cfg.replace(model=cfg.model.replace(spectral_norm=True, equalized_lr=False))


def randomize_biases(nets, seed: int) -> None:
    """Every bias N(0, 0.2) from ``seed`` (the initializers set them to 0),
    so that B4's bias term shows in the comparisons."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in nets.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))


def generation_inputs(cfg, batch: int, seed: int):
    """Batches of two steps, their noise and the penalty's draws, on the
    CPU: (batches, {"g_step": z, "d_step": z}, gp_noise)."""
    import numpy as np
    import torch
    from twingan_tpu_torch.models.pggan import noise_shape

    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    res = cfg.model.resolution
    batches = [{"target": torch.from_numpy(rng.rand(batch, res, res, 3).astype("float32"))}
               for _ in range(2)]
    zs = {k: torch.randn(noise_shape(cfg.model, batch), generator=gen)
          for k in ("g_step", "d_step")}
    gp_noise = {"alpha": torch.rand(batch, 1, 1, 1, generator=gen),
                "noise": torch.rand(batch, res, res, 3, generator=gen) * 2 - 1}
    return batches, zs, gp_noise


def compare_generation_steps(cfg, weights, batches, zs, gp_noise, card: str = "cuda",
                             phase: str = "generation", **kw) -> list:
    """``compare_steps`` for GanTrainer: its optimizers name parameters
    inside their network, pggan256 has no attention, so there is no
    projection check, and its D step's generator pass runs B4."""
    from twingan_tpu_torch.train.gan_trainer import GanTrainer

    limits = {dtype: (*lim[:3], None) for dtype, lim in TRAIN_LIMITS.items()}
    return compare_steps(cfg, weights, batches, gp_noise, card, GanTrainer, zs, phase,
                         limits, {"g_step": "generator.", "d_step": "discriminator."},
                         b4_steps=("d_step",), **kw)


def generation_phase(card: str, smi_line: str) -> dict:
    """Returns B4's launches in the timed rounds and in ``sample``."""
    from twingan_tpu_torch.train.gan_trainer import GanTrainer

    cfg = generation_config()
    trainer = GanTrainer(cfg)  # the card, by default
    state = trainer.init_state(SEED)
    randomize_biases(state.nets, SEED)
    weights = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
    batches, zs, gp_noise = generation_inputs(cfg, GEN_COMPARE_BATCH, SEED + 3)
    for row in compare_generation_steps(cfg.replace(batch_size=GEN_COMPARE_BATCH), weights,
                                        batches, zs, gp_noise):
        row["batch"] = GEN_COMPARE_BATCH
        emit(row)
        if not row["ok"]:
            fail("generation", f"the card's {row['check']} disagrees beyond the limits")
    return generation_rounds(card, smi_line, trainer, state, "generation")


def generation_rounds(card: str, smi_line: str, trainer, state, phase: str) -> dict:
    """One warm-up and GEN_TIMED_ROUNDS timed rounds of ``trainer`` (pggan256
    at batch GEN_BATCH, in its config's type) from ``state``, with B4's
    launches asserted (13 a D step, all on the variant of the type; the G
    step's 13 on the autograd route), then a ``sample`` of GEN_BATCH images
    held against the CPU's fp32 within ``SERVE_TOLS`` of the type. Returns
    B4's launches in the rounds and in ``sample``."""
    import numpy as np
    import torch
    from twingan_tpu_torch.models.pggan import noise_shape
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.train.gan_trainer import GanTrainer

    cfg = trainer.cfg
    dtype = cfg.model.dtype
    rng = np.random.RandomState(SEED + 4)
    res = cfg.model.resolution
    rounds = [[{"target": torch.from_numpy(rng.rand(GEN_BATCH, res, res, 3).astype("float32"))
                .to("cuda")} for _ in range(cfg.n_critic)] for _ in range(1 + GEN_TIMED_ROUNDS)]
    state, _ = trainer.round_step(state, rounds[0], rng=SEED)  # warm-up
    torch.cuda.synchronize()
    fused_conv.reset_launch_counts()
    attention.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    round_s, losses = [], []
    for batches in rounds[1:]:
        t0 = time.perf_counter()
        state, m = trainer.round_step(state, batches, rng=SEED)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    counts = dict(fused_conv.launch_counts)
    variants = dict(fused_conv.variant_counts)
    attention_counts = dict(attention.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    d_steps = GEN_TIMED_ROUNDS * (cfg.n_critic - 1)
    expected = {fused_conv.KERNEL_NAME: GEN_LAYERS_PER_PASS * d_steps,
                fused_conv.AUTOGRAD_ROUTE: GEN_LAYERS_PER_PASS * GEN_TIMED_ROUNDS}
    # B4 on the variant of the type only.
    want = f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[getattr(torch, dtype)]}"

    def only(launches: int) -> dict:
        return {k: (launches if k == want else 0) for k in fused_conv.variant_counts}

    finite = all(np.isfinite(v) for m in losses for v in m.values())
    med = statistics.median(round_s)
    row = {"phase": phase, "check": "timed rounds", "dtype": dtype,
           "rounds": GEN_TIMED_ROUNDS,
           "batch": GEN_BATCH, "n_critic": cfg.n_critic, "round_s": round_s,
           "rounds_per_s": 1.0 / med, "images_per_s": cfg.n_critic * GEN_BATCH / med,
           "timing": "synchronized host clock around each round; images/s counts "
                     "n_critic * batch per round",
           "peak_memory_bytes": peak, "launches": counts, "expected_launches": expected,
           "kernel_variants": variants, "attention_launches": attention_counts,
           "losses": losses, "card": card, "nvidia_smi": smi_line,
           "ok": bool(counts == expected and variants == only(expected[fused_conv.KERNEL_NAME])
                      and not any(attention_counts.values()) and finite)}
    MEASURED[f"generation_rounds_per_s_{dtype}"] = row["rounds_per_s"]
    emit(row)
    if not row["ok"]:
        fail(phase, f"the timed rounds' B4 launches differ from 13 per D step, all {want}, "
                    "and 13 autograd-route steps per G step, or a loss is not finite")

    z = torch.randn(noise_shape(cfg.model, GEN_BATCH),
                    generator=torch.Generator().manual_seed(SEED + 5))
    fused_conv.reset_launch_counts()
    out = trainer.sample(state, z).float()
    torch.cuda.synchronize()
    sample_counts = dict(fused_conv.launch_counts)
    sample_variants = dict(fused_conv.variant_counts)
    cpu = GanTrainer(cfg.replace(model=cfg.model.replace(dtype="float32")), device="cpu")
    nets = cpu.build_nets()
    nets.load_state_dict({k: v.cpu() for k, v in state.nets.state_dict().items()})
    ref = cpu.sample(cpu.state_from_nets(nets, step=state.step), z)
    out = out.cpu()
    std = float(ref.std())
    diff = (out - ref).abs()
    mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
    mean_tol, max_tol = SERVE_TOLS[dtype]
    row = {"phase": phase, "check": f"sample, card {dtype} vs CPU float32",
           "images": GEN_BATCH, "output_shape": list(out.shape),
           "finite": bool(torch.isfinite(out).all()), "step": state.step,
           "launches": sample_counts, "kernel_variants": sample_variants, "output_std": std,
           "mean_abs_err_over_std": mean_err, "max_abs_err_over_std": max_err,
           "mean_tolerance": mean_tol, "max_tolerance": max_tol,
           "ok": bool(tuple(out.shape) == (GEN_BATCH, res, res, cfg.model.image_channels)
                      and bool(torch.isfinite(out).all())
                      and sample_counts == {fused_conv.KERNEL_NAME: GEN_LAYERS_PER_PASS,
                                            fused_conv.AUTOGRAD_ROUTE: 0}
                      and sample_variants == only(GEN_LAYERS_PER_PASS)
                      and mean_err <= mean_tol and max_err <= max_tol)}
    emit(row)
    if not row["ok"]:
        fail(phase, f"the card's samples disagree with the fp32 CPU run, or sample did not "
                    f"launch {want} once per conv-leaky-pixel-norm layer")
    return {"rounds": counts[fused_conv.KERNEL_NAME],
            "sample": sample_counts[fused_conv.KERNEL_NAME]}


def counting_runner(cfg, stage_rows: list):
    """A ``StageRunner`` whose stages each set the kernels' counts to 0 just
    before they run and read them just after, with the stage's wall time
    and peak device memory: one row per stage into ``stage_rows``."""
    return counting_runner_class(stage_rows)(cfg)  # the card, by default


def counting_runner_class(stage_rows: list):
    """The class of ``counting_runner``, for a caller that builds the
    runner itself (the training command)."""
    import torch
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.runner.stage_runner import StageRunner

    class CountingRunner(StageRunner):
        def _run_stage(self, res, growing, steps, stage_dir, prev_stage_dir, cm):
            torch.cuda.synchronize()
            attention.reset_launch_counts()
            fused_conv.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            info = super()._run_stage(res, growing, steps, stage_dir, prev_stage_dir, cm)
            torch.cuda.synchronize()
            rounds = info["steps"] - info["started"].get("resumed_at", 0)
            stage_rows.append({
                "stage": os.path.basename(stage_dir), "resolution": res, "growing": growing,
                "steps": info["steps"], "rounds": rounds,
                "rounds_per_s": rounds / info["rounds_s"],
                "stage_wall_s": time.perf_counter() - t0,
                "parts_s": {k: info[k] for k in ("build_s", "restore_s", "data_s", "rounds_s",
                                                 "saves_s")},
                "saves": info["saves"], "started": info["started"],
                "nan_recoveries": info["nan_recoveries"],
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "attention_launches": dict(attention.launch_counts),
                "b4_launches": dict(fused_conv.launch_counts),
                "kernel_variants": {k: v for counts in (attention.variant_counts,
                                                        fused_conv.variant_counts)
                                    for k, v in counts.items() if v}})
            return info

    return CountingRunner


def runner_losses_ok(runner) -> bool:
    """Every logged loss of the run is finite."""
    import math

    return all(math.isfinite(r["g_loss"]) and math.isfinite(r["d_loss"])
               for r in runner.metrics_log)


def runner_phase(card: str, smi_line: str) -> dict:
    """Returns the runner path's launches by kernel."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.models.pggan import noise_shape
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.runner.checkpoint import CheckpointManager
    from twingan_tpu_torch.runner.config_io import load_stage_config
    from twingan_tpu_torch.runner.stage_runner import RunConfig, stage_dir_name, stage_plan
    from twingan_tpu_torch.train.gan_trainer import GanTrainer
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    t_phase = time.perf_counter()
    totals: dict = {}
    b4_tc = f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[torch.bfloat16]}"
    train_dir = tempfile.mkdtemp(prefix="twingan_smoke_runner_")
    try:
        # pggan256 from 4 to 256 px, in two calls on one train dir.
        cfg = RunConfig(program="image_generation", train_dir=os.path.join(train_dir, "pggan"),
                        start_hw=4, max_hw=256, num_images_per_resolution=RUNNER_PGGAN_IMAGES,
                        use_synthetic_data=True, trainer=generation_config(),
                        log_every_n_steps=1, save_every_n_steps=2, keep_checkpoints=2,
                        log_image_every_n_iter=0, seed=SEED)
        plan = [stage_dir_name(r, g) for r, g in stage_plan(cfg.start_hw, cfg.max_hw)]
        rows, summaries, runners = [], [], []
        for call_cfg in (cfg.replace(max_stages_per_run=RUNNER_FIRST_CALL_STAGES), cfg):
            runner = counting_runner(call_cfg, rows)
            summaries.append(runner.run())
            runners.append(runner)
        first, second = summaries
        n_critic = cfg.trainer.n_critic
        for row in rows:
            res = row["resolution"]
            layers = 1 + 2 * int(round(np.log2(res // 4)))
            expected = {fused_conv.KERNEL_NAME: row["rounds"] * (n_critic - 1) * layers,
                        fused_conv.AUTOGRAD_ROUTE: row["rounds"] * layers}
            row.update(phase="runner", program="image_generation", expected_b4=expected,
                       card=card, nvidia_smi=smi_line)
            row["ok"] = bool(row["b4_launches"] == expected
                             and row["kernel_variants"] == {b4_tc: expected[
                                 fused_conv.KERNEL_NAME]}
                             and not any(row["attention_launches"].values())
                             and row["nan_recoveries"] == 0)
            emit(row)
            totals[fused_conv.KERNEL_NAME] = (totals.get(fused_conv.KERNEL_NAME, 0)
                                              + row["b4_launches"][fused_conv.KERNEL_NAME])
        done = [r["stage"] for r in rows]
        grown = next((r for r in rows if r["stage"] == "32to64"), None)
        ok = (done == plan and list(first) == plan[:RUNNER_FIRST_CALL_STAGES] + ["_incomplete"]
              and all(second[s].get("skipped") for s in plan[:RUNNER_FIRST_CALL_STAGES])
              and grown is not None and grown["started"].get("from", "").endswith("/32")
              and grown["started"].get("carried", 0) > 0
              and all(r["ok"] for r in rows) and all(runner_losses_ok(r) for r in runners))
        emit({"phase": "runner", "check": "pggan256, 4 to 256 px in two calls",
              "stages": done, "first_call": list(first), "second_call_skipped": [
                  s for s in plan if second.get(s, {}).get("skipped")],
              "32to64_started": grown and grown["started"],
              "seconds": time.perf_counter() - t_phase, "ok": bool(ok)})
        if not ok:
            fail("runner", "the pggan256 plan did not train every stage in two calls, grow "
                           "32to64 from disk, launch B4's tensor-core variant as the stages' "
                           "rounds imply, or keep every loss finite")

        # The 256 stage's latest checkpoint, restored on the card and in fp32
        # on the CPU: 12 samples of each.
        stage = os.path.join(cfg.train_dir, "256")
        _, tcfg = load_stage_config(stage)
        t0 = time.perf_counter()
        trainer = GanTrainer(tcfg)
        state = CheckpointManager(stage).restore(trainer.init_state(SEED + 1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        z = torch.randn(noise_shape(tcfg.model, GEN_BATCH),
                        generator=torch.Generator().manual_seed(SEED + 6))
        fused_conv.reset_launch_counts()
        out = trainer.sample(state, z).float().cpu()
        sample_counts = dict(fused_conv.launch_counts)
        cpu = GanTrainer(tcfg.replace(model=tcfg.model.replace(dtype="float32")), device="cpu")
        ref = cpu.sample(CheckpointManager(stage).restore(cpu.init_state(SEED + 1)), z)
        std = float(ref.std())
        diff = (out - ref).abs()
        mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
        row = {"phase": "runner", "check": "restore the 256 stage, sample 12, card bf16 vs CPU "
                                           "float32", "step": state.step,
               "restore_s": restore_s, "output_shape": list(out.shape),
               "finite": bool(torch.isfinite(out).all()), "launches": sample_counts,
               "output_std": std, "mean_abs_err_over_std": mean_err,
               "max_abs_err_over_std": max_err, "mean_tolerance": SERVE_MEAN_TOL,
               "max_tolerance": SERVE_MAX_TOL,
               "ok": bool(tuple(out.shape) == (GEN_BATCH, 256, 256, 3)
                          and bool(torch.isfinite(out).all())
                          and state.step == RUNNER_PGGAN_IMAGES // GEN_BATCH
                          and sample_counts[fused_conv.KERNEL_NAME] == GEN_LAYERS_PER_PASS
                          and mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL)}
        emit(row)
        if not row["ok"]:
            fail("runner", "the restored 256 stage's samples disagree with the fp32 CPU "
                           "restore, or did not run B4")
        del trainer, state, cpu
        torch.cuda.empty_cache()

        # Where a stage's time goes once the first round and the writes are
        # spread: one fresh 256 px stage of 40 rounds.
        lcfg = cfg.replace(train_dir=os.path.join(train_dir, "pggan_long"), start_hw=256,
                           num_images_per_resolution=RUNNER_LONG_STAGE_IMAGES,
                           save_every_n_steps=RUNNER_LONG_STAGE_SAVE_EVERY)
        rows = []
        runner = counting_runner(lcfg, rows)
        runner.run()
        row = rows[0]
        layers = 1 + 2 * int(round(np.log2(256 // 4)))
        rounds = RUNNER_LONG_STAGE_IMAGES // GEN_BATCH
        expected = {fused_conv.KERNEL_NAME: rounds * (n_critic - 1) * layers,
                    fused_conv.AUTOGRAD_ROUTE: rounds * layers}
        wall = sum(row["parts_s"].values())
        row.update(phase="runner", program="image_generation",
                   check=f"pggan256, one 256 px stage of {rounds} rounds",
                   expected_b4=expected, parts_share={k: v / wall
                                                      for k, v in row["parts_s"].items()},
                   card=card, nvidia_smi=smi_line)
        row["ok"] = bool(row["rounds"] == rounds and row["b4_launches"] == expected
                         and row["kernel_variants"] == {b4_tc: expected[fused_conv.KERNEL_NAME]}
                         and row["saves"] == rounds // RUNNER_LONG_STAGE_SAVE_EVERY + 1
                         and row["nan_recoveries"] == 0 and runner_losses_ok(runner))
        MEASURED["synthetic_long_stage_rounds_per_s"] = row["rounds_per_s"]
        emit(row)
        if not row["ok"]:
            fail("runner", "the long 256 px stage did not train its rounds with B4's "
                           "tensor-core launches, write each checkpoint once, or keep its "
                           "losses finite")
        totals[fused_conv.KERNEL_NAME] += row["b4_launches"][fused_conv.KERNEL_NAME]

        # The TwinGAN slice config from 128 to 256 px.
        tcfg = RunConfig(program="twingan", train_dir=os.path.join(train_dir, "twingan"),
                         start_hw=128, max_hw=256, num_images_schedule=RUNNER_TWINGAN_IMAGES,
                         use_synthetic_data=True, trainer=slice_config(),
                         log_every_n_steps=1, save_every_n_steps=2, keep_checkpoints=2,
                         log_image_every_n_iter=0, seed=SEED)
        rows = []
        runner = counting_runner(tcfg, rows)
        summary = runner.run()
        attn = (attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL)
        for row in rows:
            trainer, _ = runner._build_trainer(row["resolution"], row["growing"], row["steps"])
            per_step = expected_launches(trainer, trainer.build_nets())
            expected = {k: row["rounds"] * (per_step["g_step"][k] + (trainer.cfg.n_critic - 1)
                                            * per_step["d_step"][k])
                        for k in per_step["g_step"]}
            variants = {f"{k}/{attention.VARIANTS[k][torch.bfloat16]}": expected[k]
                        for k in attn}
            row.update(phase="runner", program="twingan", expected_attention=expected,
                       card=card, nvidia_smi=smi_line)
            row["ok"] = bool(row["attention_launches"] == expected
                             and row["kernel_variants"] == variants
                             and not any(row["b4_launches"].values())
                             and row["nan_recoveries"] == 0)
            emit(row)
            for k in attn:
                totals[k] = totals.get(k, 0) + row["attention_launches"][k]
        inferer = ImageInferer(tcfg.train_dir)
        rng = np.random.RandomState(SEED + 7)
        images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
                  for _ in range(TRAIN_BATCH)]
        served = inferer.infer_batch(images)
        plan = [stage_dir_name(r, g) for r, g in stage_plan(tcfg.start_hw, tcfg.max_hw)]
        ok = ([r["stage"] for r in rows] == plan and all(r["ok"] for r in rows)
              and runner_losses_ok(runner) and inferer.step == summary["256"]["steps"]
              and served.shape == (TRAIN_BATCH, 256, 256, 3) and np.isfinite(served).all())
        emit({"phase": "runner", "check": "TwinGAN slice config, 128 to 256 px, served from "
                                          "model.pt", "stages": [r["stage"] for r in rows],
              "served_shape": list(served.shape), "served_finite": bool(np.isfinite(served).all()),
              "seconds": time.perf_counter() - t_phase, "ok": bool(ok)})
        if not ok:
            fail("runner", "the TwinGAN plan did not train its 3 stages with B1-B3's "
                           "tensor-core launches as the passes imply, keep its losses "
                           "finite, or serve from its model.pt")
        return totals
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img) -> bytes:
    """uint8 [H, W, 3] -> an 8-bit RGB PNG file whose row r is filtered by
    type r % 5 (None, Sub, Up, Average, Paeth), so that decoding it runs
    every filter."""
    import struct
    import zlib

    import numpy as np

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    left = np.concatenate([np.zeros((h, c), np.int16), x[:, :-c]], axis=1)
    up = np.concatenate([np.zeros((1, w * c), np.int16), x[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((h, c), np.int16), up[:, :-c]], axis=1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kinds = np.arange(h) % 5
    filtered = ((x - preds[kinds, np.arange(h)]) % 256).astype(np.uint8)
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], filtered], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def smooth_images(n: int, h: int, w: int, seed: int):
    """n smooth random uint8 [h, w, 3] images: coarse and finer noise,
    drawn on the CPU from ``seed`` and interpolated bicubically on the
    card."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(n, 3, 6, 6, generator=g).cuda()
    fine = torch.rand(n, 3, 40, 40, generator=g).cuda()
    x = (F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False) * 0.8
         + F.interpolate(fine, size=(h, w), mode="bicubic", align_corners=False) * 0.3 - 0.05)
    return (x.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def data_phase(card: str, smi_line: str, root: str) -> dict:
    """Writes the dataset under ``root``, reads it back through
    ``TFRecordSource`` and times the host data path. Returns the domains'
    shard directories and images."""
    import numpy as np
    import torch
    from twingan_tpu_torch import native
    from twingan_tpu_torch.data.datasets import get_dataset
    from twingan_tpu_torch.data.example import decode_example, encode_example
    from twingan_tpu_torch.data.pipeline import DeviceResidentSampler, TFRecordSource
    from twingan_tpu_torch.data.png import decode_png, row_filters
    from twingan_tpu_torch.data.preprocess import PreprocessConfig, host_resize_uint8
    from twingan_tpu_torch.data.tfrecord import TFRecordReader, TFRecordWriter, list_shards

    t_phase = time.perf_counter()
    lib = native.load()
    out: dict = {"images": {}}
    t0 = time.perf_counter()
    written = 0
    for d, dom in enumerate(("a", "b")):
        images = []
        per_shape = DATA_IMAGES // len(DATA_SHAPES)
        for s, (h, w) in enumerate(DATA_SHAPES):
            images += list(smooth_images(per_shape, h, w, SEED + 20 + 2 * d + s))
        with ThreadPoolExecutor(8) as pool:
            encoded = list(pool.map(encode_png, images))
        out_dir = os.path.join(root, dom)
        # Shards interleave the shapes: image i goes to shard i % DATA_SHARDS.
        for shard in range(DATA_SHARDS):
            path = os.path.join(out_dir, f"image_only_train_{shard:05d}-of-{DATA_SHARDS:05d}"
                                         ".tfrecord")
            with TFRecordWriter(path) as wr:
                for i in range(shard, DATA_IMAGES, DATA_SHARDS):
                    wr.write(encode_example({"image/encoded": encoded[i],
                                             "image/format": b"png",
                                             "image/filename": f"{dom}_{i:04d}.png".encode()}))
                    written += len(encoded[i])
        out[dom] = out_dir
        out["images"][dom] = {f"{dom}_{i:04d}.png": img for i, img in enumerate(images)}
    write_s = time.perf_counter() - t0

    # Every image back through TFRecordSource (no resize) equals its array.
    mismatched, seen = [], 0
    for dom in ("a", "b"):
        src = TFRecordSource(get_dataset("image_only"), list_shards(out[dom], "train"),
                             PreprocessConfig(output_hw=256, resize_mode="NONE"), 1,
                             seed=SEED, repeat=False, drop_remainder=False, cache=False,
                             yield_uint8=True)
        for batch in src:
            name = bytes(batch["filename"][0]).decode()
            seen += 1
            if not np.array_equal(batch["source"][0], out["images"][dom][name]):
                mismatched.append(name)
    payloads = [bytes(decode_example(p)["image/encoded"][0])
                for p in TFRecordReader(list_shards(out["a"], "train")[0])]
    filters = sorted(set(row_filters(payloads[0])))
    t0 = time.perf_counter()
    for p in payloads:
        decode_png(p)
    decode_ms = (time.perf_counter() - t0) / len(payloads) * 1e3
    resize_ms = {}
    sample = ([v for k, v in out["images"]["a"].items() if v.shape[0] == DATA_SHAPES[0][0]]
              [:DATA_TIMED_IMAGES]
              + [v for v in out["images"]["a"].values() if v.shape[0] == DATA_SHAPES[1][0]]
              [:DATA_TIMED_IMAGES])
    for hw in DATA_RESIZE_HW:
        t0 = time.perf_counter()
        for img in sample:
            host_resize_uint8(img, "PAD", hw)
        resize_ms[hw] = (time.perf_counter() - t0) / len(sample) * 1e3
    # One 256 px stage's host data path: decode and resize every image of
    # A, then the copy to the card.
    src = TFRecordSource(get_dataset("image_only", use_target=True),
                         list_shards(out["a"], "train"),
                         PreprocessConfig(output_hw=256, resize_mode="PAD"), GEN_BATCH,
                         seed=SEED, yield_uint8=True)
    t0 = time.perf_counter()
    arrays = src.materialize(4 << 30)
    materialize_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = DeviceResidentSampler([(arrays, {"target": "target"}, SEED)], GEN_BATCH, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    row = {"phase": "data", "check": "write, read back, decode and resize",
           "domains": {d: {"images": DATA_IMAGES, "shards": DATA_SHARDS,
                           "shapes_hw": [list(s) for s in DATA_SHAPES]} for d in ("a", "b")},
           "png_bytes": written, "write_s": write_s, "read_back": seen,
           "mismatched": mismatched[:5], "native_library": bool(lib is not None),
           "filters_in_first_file": filters, "decode_ms_per_image": decode_ms,
           "host_resize_ms_per_image": resize_ms,
           "stage_256_materialize_s": materialize_s,
           "stage_256_materialize_ms_per_image": materialize_s / DATA_IMAGES * 1e3,
           "device_resident_bytes": sampler.resident_bytes, "upload_s": upload_s,
           "seconds": time.perf_counter() - t_phase, "card": card, "nvidia_smi": smi_line}
    row["ok"] = bool(lib is not None and not mismatched and seen == 2 * DATA_IMAGES
                     and filters == [0, 1, 2, 3, 4]
                     and sampler.resident_bytes == DATA_IMAGES * 256 * 256 * 3)
    emit(row)
    if not row["ok"]:
        fail("data", "the native library did not load, or an image read back through "
                     "TFRecordSource differs from the array it was written from")
    del sampler
    return out


def swd_files_ok(stage_dir: str, steps: list) -> bool:
    """Each ``swd_in_training_<step>.txt`` exists and holds finite scores."""
    import math

    for step in steps:
        path = os.path.join(stage_dir, f"swd_in_training_{step}.txt")
        if not os.path.exists(path):
            return False
        rows = [line.split("\t") for line in open(path).read().splitlines()[2:]]
        if not rows or not all(math.isfinite(float(v)) for r in rows for v in r[1:]):
            return False
    return True


def runner_data_phase(card: str, smi_line: str, data: dict) -> dict:
    """Progressive training on the dataset. Returns the launches by
    kernel and the TwinGAN train dir (which the eval phase reads)."""
    import numpy as np
    import torch
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.runner import pggan_runner, stage_runner
    from twingan_tpu_torch.runner.stage_runner import RunConfig, stage_dir_name, stage_plan

    t_phase = time.perf_counter()
    totals: dict = {}
    b4_tc = f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[torch.bfloat16]}"
    root = data["root"]

    # pggan256 from 4 to 256 px on domain A, through the CLI's flags.
    argv = ["--program_name=image_generation", f"--train_dir={os.path.join(root, 'pggan')}",
            "--start_hw=4", "--max_hw=256",
            f"--num_images_per_resolution={RUNNER_PGGAN_IMAGES}", f"--dataset_dir={data['a']}",
            "--generator_norm_type=none", "--do_pixel_norm=true",
            "--equalized_learning_rate=true", "--dtype=bfloat16", "--log_every_n_steps=1",
            "--save_every_n_steps=2", "--keep_checkpoints=2", "--log_image_every_n_iter=0",
            f"--eval_every_n_iter_in_training={RUNNER_DATA_SWD_EVERY}", f"--seed={SEED}"]
    cfg = pggan_runner.config_from_args(pggan_runner.build_parser().parse_args(argv))
    rows: list = []
    runner = counting_runner(cfg, rows)
    runner.run()
    n_critic = cfg.trainer.n_critic
    for row in rows:
        res = row["resolution"]
        layers = 1 + 2 * int(round(np.log2(res // 4)))
        evals = row["steps"] // RUNNER_DATA_SWD_EVERY if res >= 16 else 0
        expected = {fused_conv.KERNEL_NAME: (row["rounds"] * (n_critic - 1) + evals) * layers,
                    fused_conv.AUTOGRAD_ROUTE: row["rounds"] * layers}
        swd_steps = [RUNNER_DATA_SWD_EVERY * (k + 1) for k in range(evals)]
        stage_dir = os.path.join(cfg.train_dir, row["stage"])
        row.update(phase="runner_data", program="image_generation", expected_b4=expected,
                   swd_evals=evals, swd_files=[f"swd_in_training_{s}.txt" for s in swd_steps],
                   card=card, nvidia_smi=smi_line)
        row["ok"] = bool(row["b4_launches"] == expected
                         and row["kernel_variants"] == {b4_tc: expected[fused_conv.KERNEL_NAME]}
                         and not any(row["attention_launches"].values())
                         and row["nan_recoveries"] == 0
                         and swd_files_ok(stage_dir, swd_steps)
                         and (res < 16 or evals >= 1))
        emit(row)
        totals[fused_conv.KERNEL_NAME] = (totals.get(fused_conv.KERNEL_NAME, 0)
                                          + row["b4_launches"][fused_conv.KERNEL_NAME])
    plan = [stage_dir_name(r, g) for r, g in stage_plan(cfg.start_hw, cfg.max_hw)]
    ok = ([r["stage"] for r in rows] == plan and all(r["ok"] for r in rows)
          and runner_losses_ok(runner))
    emit({"phase": "runner_data", "check": "pggan256, 4 to 256 px on the dataset, device-"
                                           "resident, the in-training SWD at 16 px and up",
          "stages": [r["stage"] for r in rows],
          "seconds": time.perf_counter() - t_phase, "ok": bool(ok)})
    if not ok:
        fail("runner_data", "the pggan256 plan on the dataset did not train every stage with "
                            "B4's tensor-core launches as its rounds and SWD samples imply, "
                            "write finite in-training SWD files, or keep its losses finite")

    # One fresh 256 px stage of 40 rounds on the dataset, then the same stage
    # streamed through the DevicePrefetcher for 10 rounds: the raw batches
    # of both (recorded on the card as they reach the augmentation) match.
    recorded: dict = {}
    orig_augment = stage_runner.augment_batch

    def recording(key: str, limit: int):
        def spy(images, *a, **kw):
            seen = recorded.setdefault(key, [])
            if len(seen) < limit:
                seen.append(images.clone())
            return orig_augment(images, *a, **kw)
        return spy

    long_cfg = cfg.replace(train_dir=os.path.join(root, "pggan_long"), start_hw=256,
                           num_images_per_resolution=RUNNER_LONG_STAGE_IMAGES,
                           save_every_n_steps=RUNNER_LONG_STAGE_SAVE_EVERY,
                           eval_every_n_iter_in_training=0)
    stream_cfg = long_cfg.replace(train_dir=os.path.join(root, "pggan_stream"),
                                  num_images_per_resolution=RUNNER_DATA_STREAM_ROUNDS * GEN_BATCH,
                                  device_resident_gb=0.0)
    layers = 1 + 2 * int(round(np.log2(256 // 4)))
    long_rows = {}
    for key, run_cfg in (("resident", long_cfg), ("streaming", stream_cfg)):
        stage_runner.augment_batch = recording(key, RUNNER_DATA_STREAM_ROUNDS * n_critic)
        try:
            rows = []
            runner = counting_runner(run_cfg, rows)
            runner.run()
        finally:
            stage_runner.augment_batch = orig_augment
        row = rows[0]
        rounds = run_cfg.num_images_per_resolution // GEN_BATCH
        expected = {fused_conv.KERNEL_NAME: rounds * (n_critic - 1) * layers,
                    fused_conv.AUTOGRAD_ROUTE: rounds * layers}
        wall = sum(row["parts_s"].values())
        row.update(phase="runner_data", program="image_generation",
                   check=f"pggan256, one 256 px stage of {rounds} rounds on the dataset, "
                         + ("device-resident" if key == "resident" else
                            "streamed by the DevicePrefetcher"),
                   expected_b4=expected, parts_share={k: v / wall
                                                      for k, v in row["parts_s"].items()},
                   card=card, nvidia_smi=smi_line)
        row["ok"] = bool(row["rounds"] == rounds and row["b4_launches"] == expected
                         and row["kernel_variants"] == {b4_tc: expected[fused_conv.KERNEL_NAME]}
                         and row["nan_recoveries"] == 0 and runner_losses_ok(runner))
        if key == "resident":
            row["synthetic_long_stage_rounds_per_s"] = MEASURED.get(
                "synthetic_long_stage_rounds_per_s")
            row["generation_phase_rounds_per_s"] = MEASURED.get("generation_rounds_per_s_bfloat16")
            row["ms_per_round_beyond_generation"] = (
                1e3 / row["rounds_per_s"] - 1e3 / MEASURED["generation_rounds_per_s_bfloat16"]
                if MEASURED.get("generation_rounds_per_s_bfloat16") else None)
        emit(row)
        long_rows[key] = row
        totals[fused_conv.KERNEL_NAME] += row["b4_launches"][fused_conv.KERNEL_NAME]
    a, b = recorded.get("resident", []), recorded.get("streaming", [])
    same = len(a) == len(b) == RUNNER_DATA_STREAM_ROUNDS * n_critic and all(
        x.dtype == torch.uint8 and torch.equal(x, y) for x, y in zip(a, b))
    emit({"phase": "runner_data", "check": "streamed batches equal the resident ones",
          "batches_compared": len(b), "bit_equal": bool(same),
          "ok": bool(same and all(r["ok"] for r in long_rows.values()))})
    if not same or not all(r["ok"] for r in long_rows.values()):
        fail("runner_data", "the 256 px stage on the dataset did not train its rounds with "
                            "B4's tensor-core launches, or the streamed batches differ from "
                            "the device-resident ones")
    del recorded, a, b
    torch.cuda.empty_cache()

    # The TwinGAN slice config from 128 to 256 px, A as source, B as target.
    tcfg = RunConfig(program="twingan", train_dir=os.path.join(root, "twingan"),
                     start_hw=128, max_hw=256, num_images_schedule=RUNNER_TWINGAN_IMAGES,
                     dataset_dir=data["a"], target_dataset_dir=data["b"],
                     trainer=slice_config(), log_every_n_steps=1, save_every_n_steps=2,
                     keep_checkpoints=2, log_image_every_n_iter=0, seed=SEED)
    rows = []
    runner = counting_runner(tcfg, rows)
    runner.run()
    attn = (attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL)
    for row in rows:
        trainer, _ = runner._build_trainer(row["resolution"], row["growing"], row["steps"])
        per_step = expected_launches(trainer, trainer.build_nets())
        expected = {k: row["rounds"] * (per_step["g_step"][k] + (trainer.cfg.n_critic - 1)
                                        * per_step["d_step"][k])
                    for k in per_step["g_step"]}
        variants = {f"{k}/{attention.VARIANTS[k][torch.bfloat16]}": expected[k] for k in attn}
        row.update(phase="runner_data", program="twingan", expected_attention=expected,
                   card=card, nvidia_smi=smi_line)
        row["ok"] = bool(row["attention_launches"] == expected
                         and row["kernel_variants"] == variants
                         and not any(row["b4_launches"].values())
                         and row["nan_recoveries"] == 0)
        emit(row)
        for k in attn:
            totals[k] = totals.get(k, 0) + row["attention_launches"][k]
    plan = [stage_dir_name(r, g) for r, g in stage_plan(tcfg.start_hw, tcfg.max_hw)]
    ok = ([r["stage"] for r in rows] == plan and all(r["ok"] for r in rows)
          and runner_losses_ok(runner))
    emit({"phase": "runner_data", "check": "TwinGAN slice config, 128 to 256 px, A as source "
                                           "and B as target", "stages": [r["stage"] for r in rows],
          "seconds": time.perf_counter() - t_phase, "ok": bool(ok)})
    if not ok:
        fail("runner_data", "the TwinGAN plan on the dataset did not train its 3 stages with "
                            "B1-B3's tensor-core launches as the passes imply, or keep its "
                            "losses finite")
    return {"launches": totals, "twingan_dir": tcfg.train_dir}


def eval_phase(card: str, smi_line: str, data: dict, twingan_dir: str) -> dict:
    """``run_eval`` on the TwinGAN run's final stage, then the card's SWD
    and MS-SSIM against the CPU's. Returns the launches by kernel."""
    import math

    import numpy as np
    import torch
    from twingan_tpu_torch.evals import metrics, run_eval
    from twingan_tpu_torch.ops import attention, swd
    from twingan_tpu_torch.data.preprocess import host_resize_uint8
    from twingan_tpu_torch.runner.config_io import find_latest_stage_dir, load_stage_config
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    t_phase = time.perf_counter()
    stage = find_latest_stage_dir(twingan_dir)
    _, tcfg = load_stage_config(stage)
    trainer = TwinGANTrainer(tcfg)
    g_step = expected_launches(trainer, trainer.build_nets())["g_step"]
    del trainer
    fwd = attention.KERNEL_NAME
    tc = {k: f"{k}/{attention.VARIANTS[k][torch.bfloat16]}"
          for k in (fwd, attention.DQ_KERNEL, attention.DKV_KERNEL)}
    base = [f"--model_path={twingan_dir}", f"--dataset_dir={data['a']}",
            f"--target_dataset_dir={data['b']}", f"--seed={SEED}"]
    n_batches = lambda n, b: -(-n // b)  # noqa: E731
    modes = [
        ("swd", [f"--swd_num_images={EVAL_SWD_IMAGES}", f"--batch_size={EVAL_BATCH}"],
         {fwd: 2 * n_batches(EVAL_SWD_IMAGES, EVAL_BATCH)}),
        ("msssim", [f"--num_images={EVAL_MSSSIM_IMAGES}", f"--batch_size={EVAL_BATCH}"],
         {fwd: 4 * n_batches(EVAL_MSSSIM_IMAGES, EVAL_BATCH)}),  # s2t, then back t2s
        ("loss", [f"--num_images={EVAL_LOSS_IMAGES}", f"--batch_size={EVAL_LOSS_BATCH}"],
         {k: n_batches(EVAL_LOSS_IMAGES, EVAL_LOSS_BATCH) * g_step[k] for k in tc}),
        ("output", [f"--num_images={EVAL_OUTPUT_IMAGES}", f"--batch_size={EVAL_BATCH}"],
         {fwd: n_batches(EVAL_OUTPUT_IMAGES, EVAL_BATCH)}),  # the encoder only
    ]
    totals: dict = {}
    spied = {"chunked": 0, "swd_s": 0.0}
    orig_chunked, orig_swd_eval = metrics.sliced_wasserstein_distance_chunked, run_eval.swd_eval

    def chunked_spy(*a, **kw):
        spied["chunked"] += 1
        return orig_chunked(*a, **kw)

    def swd_eval_timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_swd_eval(*a, **kw)
        torch.cuda.synchronize()
        spied["swd_s"] = time.perf_counter() - t0
        return out

    eval_root = os.path.join(data["root"], "eval")
    for mode, extra, expected in modes:
        expected = {k: expected.get(k, 0) for k in tc}
        metrics.sliced_wasserstein_distance_chunked = chunked_spy
        run_eval.swd_eval = swd_eval_timed
        try:
            torch.cuda.synchronize()
            attention.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = run_eval.main([f"--mode={mode}", f"--eval_dir={eval_root}/{mode}"]
                                   + base + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            metrics.sliced_wasserstein_distance_chunked = orig_chunked
            run_eval.swd_eval = orig_swd_eval
        launches = {k: attention.launch_counts[k] for k in tc}
        variants = {tc[k]: attention.variant_counts[tc[k]] for k in tc}
        if mode == "swd":
            values = [v for pair in (result["table"] or {}).values() for v in pair]
            checked = (result["images"] >= EVAL_SWD_IMAGES and spied["chunked"] == 1
                       and list(result["table"] or {}) == [256, 128, 64, 32, 16]
                       and all(math.isfinite(v) for v in values))
            summary = {"table": result["table"], "swd_seconds": spied["swd_s"],
                       "chunked_path": spied["chunked"] == 1}
        elif mode == "msssim":
            checked = (result["images"] >= EVAL_MSSSIM_IMAGES
                       and math.isfinite(result["diversity"])
                       and math.isfinite(result["fidelity"]))
            summary = {k: result[k] for k in ("diversity", "fidelity", "images")}
        elif mode == "loss":
            checked = bool(result["losses"]) and all(math.isfinite(v)
                                                    for v in result["losses"].values())
            summary = {"losses": result["losses"]}
        else:
            lines = open(result["path"]).read().splitlines()
            checked = result["images"] == EVAL_OUTPUT_IMAGES and len(lines) == EVAL_OUTPUT_IMAGES
            summary = {"rows": len(lines)}
        row = {"phase": "eval", "mode": mode, "stage": os.path.basename(stage),
               "seconds": seconds, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "attention_launches": launches, "expected_attention": expected,
               "kernel_variants": variants, **summary, "card": card, "nvidia_smi": smi_line}
        row["ok"] = bool(checked and launches == expected
                         and variants == {tc[k]: expected[k] for k in tc})
        emit(row)
        if not row["ok"]:
            fail("eval", f"run_eval --mode={mode} gave no finite result, or its attention "
                         "launches differ from its translations' and passes' count on the "
                         "tensor-core variants")
        for k in tc:
            totals[k] = totals.get(k, 0) + launches[k]

    # The card's SWD (both paths) and MS-SSIM of fixed images against the
    # CPU's with the same draws.
    names = sorted(data["images"]["a"])[:EVAL_COMPARE_IMAGES]
    fake = np.stack([host_resize_uint8(data["images"]["a"][n], "PAD", 256)
                     for n in names]).astype(np.float32) / 255.0
    names = sorted(data["images"]["b"])[:EVAL_COMPARE_IMAGES]
    real = np.stack([host_resize_uint8(data["images"]["b"][n], "PAD", 256)
                     for n in names]).astype(np.float32) / 255.0
    compare = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        table = metrics.swd_eval(SEED, [real], [fake], num_images=EVAL_COMPARE_IMAGES,
                                 device=dev)
        compare[dev] = {
            "swd": np.array(list(table.values()), np.float64),
            "swd_chunked": swd.sliced_wasserstein_distance_chunked(
                real, fake, seed=SEED, device=dev).astype(np.float64) * 1e3,
            "pairwise_msssim": metrics.pairwise_msssim(real, fake, device=dev),
            "msssim_eval": metrics.msssim_eval([real], device=dev)}
    card_row, cpu_row = compare["cuda"], compare["cpu"]
    rel = {k: float(np.max(np.abs(card_row[k] - cpu_row[k]) / np.abs(cpu_row[k])))
           for k in ("swd", "swd_chunked")}
    absd = {k: abs(card_row[k] - cpu_row[k]) for k in ("pairwise_msssim", "msssim_eval")}
    row = {"phase": "eval", "check": f"SWD and MS-SSIM of {EVAL_COMPARE_IMAGES} fixed images, "
                                     "card vs CPU, the same draws",
           "swd_card": card_row["swd"].tolist(), "swd_cpu": cpu_row["swd"].tolist(),
           "swd_chunked_card": card_row["swd_chunked"].tolist(),
           "swd_chunked_cpu": cpu_row["swd_chunked"].tolist(),
           "max_rel_diff": rel, "swd_rtol": SWD_RTOL,
           "msssim_card": {k: card_row[k] for k in absd},
           "msssim_cpu": {k: cpu_row[k] for k in absd}, "msssim_abs_diff": absd,
           "msssim_atol": MSSSIM_ATOL, "seconds": time.perf_counter() - t0,
           "ok": bool(all(v <= SWD_RTOL for v in rel.values())
                      and all(v <= MSSSIM_ATOL for v in absd.values())
                      and all(np.isfinite(card_row["swd"]).tolist()))}
    emit(row)
    if not row["ok"]:
        fail("eval", "the card's SWD or MS-SSIM disagrees with the CPU's beyond the CPU "
                     "tests' tolerances")
    emit({"phase": "eval", "check": "run_eval on the TwinGAN run's final stage",
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return totals


def recipe_config():
    """The headline recipe at 256 px as the training command builds it from
    RECIPE_FLAGS (the CLI's parser and ``config_from_args``), at the
    recipe's 256 px batch."""
    from twingan_tpu_torch.runner import pggan_runner

    args = pggan_runner.build_parser().parse_args(
        RECIPE_FLAGS + ["--train_dir=unused", "--start_hw=256", "--max_hw=256"])
    return pggan_runner.config_from_args(args).trainer.replace(batch_size=TRAIN_BATCH)


def seed_renorm_state(nets, seed: int) -> None:
    """Every batch-renorm bank's EMAs drawn from ``seed``: weights in
    [0.85, 0.95], debiased means N(0, 1) and standard deviations
    log-uniform in [0.1, 5], off the batches' moments, so that r and d
    clip; the moving statistics N(0, 0.2) and U(0.5, 1.5)."""
    import math

    import torch
    from twingan_tpu_torch.models.layers import DomainNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in nets.modules():
            if not (isinstance(m, DomainNorm) and m.kind == "batch_renorm"):
                continue
            for d in range(m.num_domains):
                for name in ("mean", "stddev"):
                    weight = getattr(m, f"renorm_{name}_weight_{d}")
                    weight.copy_(torch.empty(()).uniform_(0.85, 0.95, generator=gen))
                    ema = getattr(m, f"renorm_{name}_{d}")
                    if name == "mean":
                        value = torch.randn(ema.shape, generator=gen)
                    else:
                        value = torch.empty(ema.shape).uniform_(
                            math.log(0.1), math.log(5.0), generator=gen).exp()
                    ema.copy_(value.to(ema.device) * weight)
                mean, var = getattr(m, f"moving_mean_{d}"), getattr(m, f"moving_var_{d}")
                mean.copy_(torch.empty(mean.shape).normal_(0.0, 0.2, generator=gen))
                var.copy_(torch.empty(var.shape).uniform_(0.5, 1.5, generator=gen))


def he_scale_kernels(nets, seed: int) -> None:
    """Every conv and dense kernel redrawn N(0, 2 / fan_in) from ``seed``.
    Without equalized lr the recipe draws N(0, 0.02), under which the
    norm-free discriminators shrink their activations layer by layer until
    the prediction (about 1e-7) is set by minibatch stddev's epsilon, which
    is 1e-8 in fp32 and 1e-6 in bf16: the two types would then compare two
    different functions. He-scaled kernels keep every layer's activations
    near unit scale, as training brings them."""
    import torch
    from twingan_tpu_torch.models.layers import EqConv, EqDense

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in nets.modules():
            if isinstance(m, (EqConv, EqDense)) and not m.equalized_lr:
                fan_in = m.kernel[0].numel() if isinstance(m, EqConv) else m.kernel.shape[0]
                m.kernel.copy_(torch.randn(m.kernel.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)


def clip_counter():
    """Wraps ``norms.batch_renorm_correction`` to count the r and d values
    it clips; returns (counts, restore)."""
    from twingan_tpu_torch.ops import norms

    counts = {"clipped": 0, "values": 0}
    real = norms.batch_renorm_correction

    def counting(mean, var, state, clip, **kw):
        r, d, new = real(mean, var, state, clip, **kw)
        rmax, rmin, dmax = (float(r.new_tensor(clip[k])) for k in ("rmax", "rmin", "dmax"))
        counts["clipped"] += int(((r == rmax) | (r == rmin) | (d.abs() == dmax)).sum())
        counts["values"] += 2 * r.numel()
        return r, d, new

    norms.batch_renorm_correction = counting
    return counts, lambda: setattr(norms, "batch_renorm_correction", real)


def recipe_phase(card: str, smi_line: str) -> dict:
    """The headline TwinGAN recipe (batch renorm) and pggan256 with spectral
    norm on the card. Returns the recipe plan's launches by kernel and the
    spectral-norm sample's B4 launches."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.models.pggan import noise_shape
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.runner import pggan_runner
    from twingan_tpu_torch.runner.checkpoint import CheckpointManager
    from twingan_tpu_torch.runner.stage_runner import stage_dir_name, stage_plan
    from twingan_tpu_torch.train.gan_trainer import GanTrainer
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    t_phase = time.perf_counter()
    attn = (attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL)
    tc = {k: f"{k}/{attention.VARIANTS[k][torch.bfloat16]}" for k in attn}

    # 1. One G and one D step of the recipe at full width, at step 10001
    # from the seeded renorm state, against fp32 on the CPU.
    cfg = recipe_config()
    trainer = TwinGANTrainer(cfg)  # the card, by default
    state = trainer.init_state(SEED)
    set_attention_gamma(state.nets)
    he_scale_kernels(state.nets, SEED + 8)
    seed_renorm_state(state.nets, SEED + 8)
    weights = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(SEED + 8)
    gen = torch.Generator().manual_seed(SEED + 8)
    res = cfg.model.resolution
    gp_noise = {d: {"alpha": torch.rand(TRAIN_BATCH, 1, 1, 1, generator=gen),
                    "noise": torch.rand(TRAIN_BATCH, res, res, 3, generator=gen) * 2 - 1}
                for d in ("s", "t")}
    counts, restore = clip_counter()
    try:
        rows = compare_steps(cfg, weights, [_train_batch(rng, cfg, "cpu") for _ in range(2)],
                             gp_noise, phase="recipe", step=RECIPE_STEP,
                             held_buffers={"renorm_": None, "moving_": None})
    finally:
        restore()
    for row in rows:
        row["clip"] = trainer._renorm_clip(RECIPE_STEP)
        emit(row)
        if not row["ok"]:
            fail("recipe", f"the card's {row['check']} disagrees beyond the limits")
    row = {"phase": "recipe", "check": "the renorm clip bites in the compared steps",
           **counts, "ok": counts["clipped"] > 0}
    emit(row)
    if not row["ok"]:
        fail("recipe", "no r or d value was clipped: the seeded renorm state does not test "
                       "the clip")

    # 2. Timed rounds at 256 px, beside the train phase's batch-norm rate.
    state = trainer.state_from_nets(trainer.build_nets())
    state.nets.load_state_dict(weights)
    rounds = [[_train_batch(rng, cfg, "cuda") for _ in range(cfg.n_critic)]
              for _ in range(1 + TRAIN_TIMED_ROUNDS)]
    state, _ = trainer.round_step(state, rounds[0], rng=SEED)  # warm-up
    torch.cuda.synchronize()
    attention.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    round_s = []
    for batches in rounds[1:]:
        t0 = time.perf_counter()
        state, m = trainer.round_step(state, batches, rng=SEED)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
    per_step = expected_launches(trainer, state.nets)
    expected = {k: TRAIN_TIMED_ROUNDS * (per_step["g_step"][k] + (cfg.n_critic - 1)
                                         * per_step["d_step"][k]) for k in attention.launch_counts}
    med = statistics.median(round_s)
    row = {"phase": "recipe", "check": "timed rounds, 256 px, batch renorm",
           "rounds": TRAIN_TIMED_ROUNDS, "batch": TRAIN_BATCH, "round_s": round_s,
           "rounds_per_s": 1.0 / med, "images_per_s": cfg.n_critic * TRAIN_BATCH / med,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "batch_norm_rounds_per_s": MEASURED.get("train_rounds_per_s_bfloat16"),
           "batch_norm_peak_memory_bytes": MEASURED.get("train_peak_memory_bytes_bfloat16"),
           "timing": "as the train phase's: synchronized host clock around each round",
           "launches": dict(attention.launch_counts), "expected_launches": expected,
           "card": card, "nvidia_smi": smi_line,
           "ok": bool(dict(attention.launch_counts) == expected
                      and all(np.isfinite(float(v)) for v in m.values()))}
    emit(row)
    if not row["ok"]:
        fail("recipe", "the recipe's timed rounds launched other than the passes imply, or a "
                       "loss is not finite")
    del trainer, state, rounds
    torch.cuda.empty_cache()

    # 3. The plan, 4 to 256 px, through the training command's main().
    totals: dict = {}
    train_dir = tempfile.mkdtemp(prefix="twingan_smoke_recipe_")
    try:
        stage_rows: list = []
        runners: list = []
        runner_cls = counting_runner_class(stage_rows)

        def build_runner(run_cfg, device=None):
            runners.append(runner_cls(run_cfg, device=device))
            return runners[-1]

        argv = RECIPE_FLAGS + [
            f"--train_dir={train_dir}", "--use_synthetic_data=true", "--start_hw=4",
            "--max_hw=256", f"--num_images_per_resolution={RECIPE_IMAGES}",
            "--log_every_n_steps=1", "--log_image_every_n_iter=0", f"--seed={SEED}"]
        real_runner = pggan_runner.StageRunner
        pggan_runner.StageRunner = build_runner
        t0 = time.perf_counter()
        try:
            summary = pggan_runner.main(argv)
        finally:
            pggan_runner.StageRunner = real_runner
        plan_s = time.perf_counter() - t0
        (runner,) = runners
        for row in stage_rows:
            trainer, _ = runner._build_trainer(row["resolution"], row["growing"], row["steps"])
            per_step = expected_launches(trainer, trainer.build_nets())
            expected = {k: row["rounds"] * (per_step["g_step"][k] + (trainer.cfg.n_critic - 1)
                                            * per_step["d_step"][k])
                        for k in per_step["g_step"]}
            flat = CheckpointManager(os.path.join(train_dir, row["stage"])).restore_dict()
            renorm = {k: v for k, v in flat.items() if "/renorm_" in k}
            weights_moved = [float(v) > 0 for k, v in renorm.items() if "_weight_" in k]
            row.update(phase="recipe", program="twingan", expected_attention=expected,
                       renorm_buffers=len(renorm),
                       renorm_finite=all(bool(torch.isfinite(v).all()) for v in renorm.values()),
                       renorm_weights_moved=f"{sum(weights_moved)}/{len(weights_moved)}",
                       card=card, nvidia_smi=smi_line)
            row["ok"] = bool(row["attention_launches"] == expected
                             and row["kernel_variants"] == {tc[k]: expected[k] for k in attn
                                                            if expected[k]}
                             and not any(row["b4_launches"].values())
                             and row["nan_recoveries"] == 0 and renorm and row["renorm_finite"]
                             and all(weights_moved))
            emit(row)
            for k in attn:
                totals[k] = totals.get(k, 0) + row["attention_launches"][k]
        stages = [r["stage"] for r in stage_rows]
        plan = [stage_dir_name(r, g) for r, g in stage_plan(4, 256)]
        with_attention = [r["stage"] for r in stage_rows if r["attention_launches"][attn[0]]]

        # The final stage served (eval mode: the moving statistics the
        # renorm EMAs set) on the card and in fp32 on the CPU.
        images = [np.random.RandomState(SEED + 9).randint(0, 256, (256, 256, 3)).astype(np.uint8)
                  for _ in range(TRAIN_BATCH)]
        attention.reset_launch_counts()
        out = ImageInferer(train_dir).infer_batch(images)
        served_launches = attention.launch_counts[attention.KERNEL_NAME]
        ref = ImageInferer(train_dir, device="cpu", dtype="float32").infer_batch(images)
        std = float(ref.std())
        diff = np.abs(out - ref)
        mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
        totals[attention.KERNEL_NAME] += served_launches
        ok = (stages == plan and all(r["ok"] for r in stage_rows)
              and with_attention == plan[plan.index("32to64"):]
              and runner_losses_ok(runner) and summary["256"]["steps"] == RECIPE_IMAGES // 3
              and out.shape == (TRAIN_BATCH, 256, 256, 3) and bool(np.isfinite(out).all())
              and served_launches == 2 and mean_err <= SERVE_MEAN_TOL
              and max_err <= SERVE_MAX_TOL)
        emit({"phase": "recipe", "check": "the recipe, 4 to 256 px through the training "
                                          "command, the 256 stage served",
              "stages": stages, "stages_with_attention": with_attention,
              "stage_wall_s": {r["stage"]: r["stage_wall_s"] for r in stage_rows},
              "plan_s": plan_s, "rounds_per_s_256": stage_rows[-1]["rounds_per_s"],
              "served_launches": served_launches, "output_std": std,
              "mean_abs_err_over_std": mean_err, "max_abs_err_over_std": max_err,
              "mean_tolerance": SERVE_MEAN_TOL, "max_tolerance": SERVE_MAX_TOL,
              "card": card, "nvidia_smi": smi_line, "ok": bool(ok)})
        if not ok:
            fail("recipe", "the recipe's plan did not train every stage with B1-B3's "
                           "tensor-core launches as its passes imply (from 64 px), keep its "
                           "losses and renorm state finite and moved, or serve its 256 stage "
                           "within serving's limits of the CPU")
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)

    # 4. pggan256 with spectral norm in the discriminator: a G and a D step
    # against the CPU with every u held; then with spectral norm in the
    # generator too, a sample on B4 (W / sigma folded in).
    sn_cfg = spectral_generation_config()
    trainer = GanTrainer(sn_cfg)
    state = trainer.init_state(SEED)
    randomize_biases(state.nets, SEED)
    weights = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
    batches, zs, gp_noise = generation_inputs(sn_cfg, GEN_COMPARE_BATCH, SEED + 10)
    for row in compare_generation_steps(sn_cfg.replace(batch_size=GEN_COMPARE_BATCH), weights,
                                        batches, zs, gp_noise, phase="recipe",
                                        held_buffers={"u": SPECTRAL_U_ATOL}):
        row.update(batch=GEN_COMPARE_BATCH, config="pggan256, spectral_norm")
        emit(row)
        if not row["ok"]:
            fail("recipe", f"pggan256 with spectral norm: the card's {row['check']} "
                           "disagrees beyond the limits")
    sn_all = sn_cfg.replace(model=sn_cfg.model.replace(spectral_norm_in_non_discriminator=True))
    trainer = GanTrainer(sn_all)
    state = trainer.init_state(SEED + 1)
    randomize_biases(state.nets, SEED + 1)
    z = torch.randn(noise_shape(sn_all.model, GEN_BATCH),
                    generator=torch.Generator().manual_seed(SEED + 11))
    fused_conv.reset_launch_counts()
    out = trainer.sample(state, z).float()
    torch.cuda.synchronize()
    sample_counts = dict(fused_conv.launch_counts)
    sample_variants = {k: v for k, v in fused_conv.variant_counts.items() if v}
    cpu = GanTrainer(sn_all.replace(model=sn_all.model.replace(dtype="float32")), device="cpu")
    nets = cpu.build_nets()
    nets.load_state_dict({k: v.cpu() for k, v in state.nets.state_dict().items()})
    ref = cpu.sample(cpu.state_from_nets(nets), z)
    out = out.cpu()
    std = float(ref.std())
    diff = (out - ref).abs()
    mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
    b4_tc = f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[torch.bfloat16]}"
    row = {"phase": "recipe", "check": "pggan256, spectral norm in the generator too: sample, "
                                       "card bf16 vs CPU float32",
           "images": GEN_BATCH, "output_shape": list(out.shape),
           "finite": bool(torch.isfinite(out).all()), "launches": sample_counts,
           "kernel_variants": sample_variants, "output_std": std,
           "mean_abs_err_over_std": mean_err, "max_abs_err_over_std": max_err,
           "mean_tolerance": SERVE_MEAN_TOL, "max_tolerance": SERVE_MAX_TOL,
           "seconds": time.perf_counter() - t_phase, "card": card, "nvidia_smi": smi_line,
           "ok": bool(tuple(out.shape) == (GEN_BATCH, 256, 256, 3)
                      and bool(torch.isfinite(out).all())
                      and sample_counts == {fused_conv.KERNEL_NAME: GEN_LAYERS_PER_PASS,
                                            fused_conv.AUTOGRAD_ROUTE: 0}
                      and sample_variants == {b4_tc: GEN_LAYERS_PER_PASS}
                      and mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL)}
    emit(row)
    if not row["ok"]:
        fail("recipe", "the spectral-norm generator's samples disagree with the fp32 CPU run, "
                       "or sample did not launch B4's tensor-core variant once per "
                       "conv-leaky-pixel-norm layer")
    totals[fused_conv.KERNEL_NAME] = sample_counts[fused_conv.KERNEL_NAME]
    return totals


def options_config(remat: bool = True):
    """The slice config at the training batch with the style embedding,
    distillation, gdrop and ``remat``."""
    cfg = train_config()
    return cfg.replace(model=cfg.model.replace(style_dim=OPTIONS_STYLE_DIM),
                       use_style_embedding=True, style_embed_size=OPTIONS_STYLE_DIM,
                       do_encoder_distillation=True, source_embed_dim=OPTIONS_EMBED_DIM,
                       target_embed_dim=OPTIONS_EMBED_DIM, use_gdrop=True, remat=remat)


def options_generation_config(optimizer: str = "rmsprop", batch: int = GEN_BATCH):
    """pggan256 with gdrop and conditional labels under ``optimizer``."""
    from twingan_tpu_torch.train.optimizers import OptimizerConfig

    cfg = generation_config(batch)
    return cfg.replace(use_gdrop=True, use_conditional_labels=True,
                       num_classes=OPTIONS_NUM_CLASSES, conditional_embed_dim=OPTIONS_COND_DIM,
                       opt=OptimizerConfig(optimizer=optimizer))


def _unit_rows(rng, n: int, dim: int):
    import numpy as np
    import torch

    e = rng.randn(n, dim).astype("float32")
    return torch.from_numpy(e / np.linalg.norm(e, axis=1, keepdims=True))


def _options_batch(rng, cfg, device):
    """A TwinGAN batch with the distillation embeddings."""
    batch = _train_batch(rng, cfg, device)
    for k in ("source_embedding", "target_embedding"):
        batch[k] = _unit_rows(rng, TRAIN_BATCH, OPTIONS_EMBED_DIM).to(device)
    return batch


def twingan_option_draws(trainer, seed: int) -> dict:
    """The random style and every discriminator pass's gdrop noise of one
    G step and one D step, drawn on the CPU from ``seed``, by the names the
    steps take them under."""
    import torch
    from twingan_tpu_torch.train.twingan_trainer import DIS_S

    gen = torch.Generator().manual_seed(seed)
    shapes = trainer.build_nets()[DIS_S].gdrop_shapes
    draw = lambda n: [torch.randn(s, generator=gen) for s in shapes(n)]  # noqa: E731
    kinds = ["prime"] + (["cycle"] if trainer._need_cycle() else [])
    out = {}
    for step, passes in (("g_step", kinds), ("d_step", ["real"] + kinds)):
        style = torch.randn(TRAIN_BATCH, trainer.cfg.style_embed_size, generator=gen)
        if trainer.cfg.fuse:
            noise = {d: draw(len(passes) * TRAIN_BATCH) for d in "st"}
        else:
            noise = {f"{d}_{k}": draw(TRAIN_BATCH) for d in "st" for k in passes}
        if step == "d_step":
            noise.update({f"{d}_gp": draw(TRAIN_BATCH) for d in "st"})
        out[step] = {"random_style": style, "gdrop_noise": noise}
    return out


def generation_option_draws(trainer, batch: int, seed: int) -> dict:
    """The gdrop noise of a GanTrainer G step and D step, on the CPU."""
    import torch
    from twingan_tpu_torch.train.gan_trainer import DIS

    gen = torch.Generator().manual_seed(seed)
    shapes = trainer.build_nets()[DIS].gdrop_shapes(batch)
    draw = lambda: [torch.randn(s, generator=gen) for s in shapes]  # noqa: E731
    return {"g_step": {"gdrop_noise": {"fake": draw()}},
            "d_step": {"gdrop_noise": {k: draw() for k in ("fake", "real", "gp")}}}


def options_phase(card: str, smi_line: str) -> dict:
    """The trainer options on the card; returns their main paths' launches
    by kernel (the timed rounds, the pggan round and sample, the CLI plan
    and its serving)."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.models.layers import SelfAttention
    from twingan_tpu_torch.models.pggan import noise_shape
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.runner import pggan_runner
    from twingan_tpu_torch.runner.stage_runner import stage_dir_name, stage_plan
    from twingan_tpu_torch.train.gan_trainer import GanTrainer
    from twingan_tpu_torch.train.twingan_trainer import ENC, ENC_STYLE, GEN, TwinGANTrainer

    t_phase = time.perf_counter()
    attn = (attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL)
    tc = {k: f"{k}/{attention.VARIANTS[k][torch.bfloat16]}" for k in attn}
    b4_tc = f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[torch.bfloat16]}"
    totals = {k: 0 for k in attn + (fused_conv.KERNEL_NAME,)}

    # 1. TwinGAN with the style embedding, distillation, gdrop and remat: a
    # G and a D step on the card against the CPU, both in float32.
    cfg = options_config(remat=True)
    trainer = TwinGANTrainer(cfg)  # the card, by default
    state = trainer.init_state(SEED)
    set_attention_gamma(state.nets)
    weights = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(SEED + 12)
    gen = torch.Generator().manual_seed(SEED + 12)
    res = cfg.model.resolution
    gp_noise = {d: {"alpha": torch.rand(TRAIN_BATCH, 1, 1, 1, generator=gen),
                    "noise": torch.rand(TRAIN_BATCH, res, res, 3, generator=gen) * 2 - 1}
                for d in ("s", "t")}
    draws = twingan_option_draws(trainer, SEED + 12)
    rows = compare_steps(cfg, weights, [_options_batch(rng, cfg, "cpu") for _ in range(2)],
                         gp_noise, phase="options", limits=OPTIONS_TWINGAN_LIMITS,
                         step=OPTIONS_STEP, gdrop_strength=OPTIONS_GDROP_STRENGTH,
                         step_kw=draws)
    want = {"l_s_style", "l_t_style", "l_source_distillation", "l_target_distillation",
            "l_s_prime_distillation", "l_t_prime_distillation"}
    for row in rows:
        row["config"] = "slice + style 16, distillation 512, gdrop 0.05 at step 101, remat"
        emit(row)
        if not row["ok"] or (row["check"].startswith("g_step") and not want <= set(row["losses"])):
            fail("options", f"the card's {row['check']} with the TwinGAN options disagrees "
                            "beyond the limits, or lacks the style and distillation losses")

    # 2. Timed rounds with and without remat, in this call: rounds/s, peak
    # memory, and the launches the passes imply (the recompute counted).
    timed = {}
    for remat in (True, False):
        rcfg = options_config(remat)
        rtrainer = TwinGANTrainer(rcfg)
        rstate = rtrainer.state_from_nets(rtrainer.build_nets(), step=OPTIONS_STEP,
                                          critic_step=2 * OPTIONS_STEP)
        rstate.nets.load_state_dict(weights)
        rstate.gdrop_strength = torch.tensor(OPTIONS_GDROP_STRENGTH, device="cuda")
        rounds = [[_options_batch(rng, rcfg, "cuda") for _ in range(rcfg.n_critic)]
                  for _ in range(1 + TRAIN_TIMED_ROUNDS)]
        rstate, _ = rtrainer.round_step(rstate, rounds[0], rng=SEED)  # warm-up
        torch.cuda.synchronize()
        attention.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        round_s, losses = [], []
        for batches in rounds[1:]:
            t0 = time.perf_counter()
            rstate, m = rtrainer.round_step(rstate, batches, rng=SEED)
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in m.items()})
        per_step = expected_launches(rtrainer, rstate.nets)
        expected = {k: TRAIN_TIMED_ROUNDS * (per_step["g_step"][k] + (rcfg.n_critic - 1)
                                             * per_step["d_step"][k])
                    for k in attention.launch_counts}
        counts = dict(attention.launch_counts)
        variants = {k: v for k, v in attention.variant_counts.items() if v}
        med = statistics.median(round_s)
        row = {"phase": "options", "check": f"timed rounds, remat {remat}", "remat": remat,
               "rounds": TRAIN_TIMED_ROUNDS, "batch": TRAIN_BATCH, "round_s": round_s,
               "rounds_per_s": 1.0 / med, "images_per_s": rcfg.n_critic * TRAIN_BATCH / med,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "timing": "as the train phase's: synchronized host clock around each round",
               "launches": counts, "expected_launches": expected,
               "expected_per_step": per_step, "kernel_variants": variants,
               "gdrop_strength": losses[-1]["gdrop_strength"],
               "card": card, "nvidia_smi": smi_line,
               "ok": bool(counts == expected
                          and variants == {tc[k]: expected[k] for k in attn}
                          and all(np.isfinite(v) for m in losses for v in m.values()))}
        timed[remat] = row
        emit(row)
        if not row["ok"]:
            fail("options", f"the timed rounds (remat {remat}) launched other than the passes "
                            "imply, ran another variant than bf16's, or lost a finite loss")
        for k in attn:
            totals[k] += counts[k]
        del rtrainer, rstate, rounds
        torch.cuda.empty_cache()
    emit({"phase": "options", "check": "remat against no remat, same config and call",
          "rounds_per_s": {str(k): v["rounds_per_s"] for k, v in timed.items()},
          "peak_memory_bytes": {str(k): v["peak_memory_bytes"] for k, v in timed.items()},
          "peak_memory_ratio": timed[True]["peak_memory_bytes"]
          / timed[False]["peak_memory_bytes"],
          "time_ratio": timed[False]["rounds_per_s"] / timed[True]["rounds_per_s"],
          "ok": True})
    del trainer, state
    torch.cuda.empty_cache()

    # 3. pggan256 with gdrop and conditional labels under rmsprop: a G and a
    # D step against the CPU (B4 in the D step), a round, and a labelled
    # sample within serving's limits; then a D step under each of adagrad,
    # adadelta and ftrl. The optimizers' updates are held too.
    gcfg = options_generation_config("rmsprop")
    gtrainer = GanTrainer(gcfg)
    gstate = gtrainer.init_state(SEED)
    randomize_biases(gstate.nets, SEED)
    gweights = {k: v.detach().cpu().clone() for k, v in gstate.nets.state_dict().items()}
    batches, zs, gp = generation_inputs(gcfg, GEN_COMPARE_BATCH, SEED + 13)
    for b in batches:
        b["conditional_labels"] = torch.from_numpy(
            rng.randint(0, OPTIONS_NUM_CLASSES, GEN_COMPARE_BATCH))
    gdraws = generation_option_draws(gtrainer, GEN_COMPARE_BATCH, SEED + 13)
    compare_kw = dict(phase="options", step=OPTIONS_STEP, gdrop_strength=OPTIONS_GDROP_STRENGTH,
                      check_updates=True)
    rows = compare_generation_steps(gcfg.replace(batch_size=GEN_COMPARE_BATCH), gweights,
                                    batches, zs, gp, step_kw=gdraws, **compare_kw)
    for optimizer in ("adagrad", "adadelta", "ftrl"):
        rows += compare_generation_steps(
            options_generation_config(optimizer, GEN_COMPARE_BATCH), gweights, batches[1:],
            {"d_step": zs["d_step"]}, gp, step_kw={"d_step": gdraws["d_step"]},
            kinds=("d_step",), **compare_kw)
    for row, optimizer in zip(rows, ["rmsprop"] * 4 + ["adagrad", "adagrad", "adadelta",
                                                        "adadelta", "ftrl", "ftrl"]):
        row.update(batch=GEN_COMPARE_BATCH, config="pggan256 + gdrop 0.05 at step 101, "
                   f"conditional labels (51 classes, 32 wide), {optimizer}")
        emit(row)
        if not row["ok"]:
            fail("options", f"pggan256 with the options ({optimizer}): the card's "
                            f"{row['check']} disagrees beyond the limits")
    gstate.step, gstate.gdrop_strength = OPTIONS_STEP, torch.tensor(
        OPTIONS_GDROP_STRENGTH, device="cuda")
    round_batches = [{"target": torch.from_numpy(rng.rand(GEN_BATCH, 256, 256, 3)
                                                 .astype("float32")).cuda(),
                      "conditional_labels": torch.from_numpy(
                          rng.randint(0, OPTIONS_NUM_CLASSES, GEN_BATCH)).cuda()}
                     for _ in range(gcfg.n_critic)]
    fused_conv.reset_launch_counts()
    gstate, m = gtrainer.round_step(gstate, round_batches, rng=SEED)
    torch.cuda.synchronize()
    round_counts = dict(fused_conv.launch_counts)
    z = torch.randn(noise_shape(gcfg.model, GEN_BATCH),
                    generator=torch.Generator().manual_seed(SEED + 14))
    labels = torch.nn.functional.one_hot(torch.arange(GEN_BATCH) % OPTIONS_NUM_CLASSES,
                                         OPTIONS_NUM_CLASSES).float()
    fused_conv.reset_launch_counts()
    out = gtrainer.sample(gstate, z, labels=labels).float().cpu()
    torch.cuda.synchronize()
    sample_counts = dict(fused_conv.launch_counts)
    sample_variants = {k: v for k, v in fused_conv.variant_counts.items() if v}
    cpu = GanTrainer(gcfg.replace(model=gcfg.model.replace(dtype="float32")), device="cpu")
    nets = cpu.build_nets()
    nets.load_state_dict({k: v.cpu() for k, v in gstate.nets.state_dict().items()})
    ref = cpu.sample(cpu.state_from_nets(nets, step=gstate.step), z, labels=labels)
    unlabelled = cpu.sample(cpu.state_from_nets(nets, step=gstate.step), z)
    std = float(ref.std())
    diff = (out - ref).abs()
    mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
    row = {"phase": "options", "check": "pggan256 options: a round, then a labelled sample, "
                                        "card bf16 vs CPU float32",
           "images": GEN_BATCH, "round_launches": round_counts,
           "round_losses": {k: float(v) for k, v in m.items()}, "launches": sample_counts,
           "kernel_variants": sample_variants, "output_std": std,
           "mean_abs_err_over_std": mean_err, "max_abs_err_over_std": max_err,
           "mean_tolerance": SERVE_MEAN_TOL, "max_tolerance": SERVE_MAX_TOL,
           "labels_move_the_cpu_output_by": float((ref - unlabelled).abs().max()),
           "card": card, "nvidia_smi": smi_line,
           "ok": bool(round_counts == {fused_conv.KERNEL_NAME: GEN_LAYERS_PER_PASS
                                       * (gcfg.n_critic - 1),
                                       fused_conv.AUTOGRAD_ROUTE: GEN_LAYERS_PER_PASS}
                      and all(np.isfinite(float(v)) for v in m.values())
                      and tuple(out.shape) == (GEN_BATCH, 256, 256, 3)
                      and sample_counts == {fused_conv.KERNEL_NAME: GEN_LAYERS_PER_PASS,
                                            fused_conv.AUTOGRAD_ROUTE: 0}
                      and sample_variants == {b4_tc: GEN_LAYERS_PER_PASS}
                      and mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL)}
    emit(row)
    if not row["ok"]:
        fail("options", "pggan256 with the options: the round or the labelled sample did not "
                        "launch B4 13 times a D step and a sample, or the sample disagrees "
                        "with the fp32 CPU run")
    totals[fused_conv.KERNEL_NAME] += (round_counts[fused_conv.KERNEL_NAME]
                                       + sample_counts[fused_conv.KERNEL_NAME])
    del gtrainer, gstate, cpu, nets
    torch.cuda.empty_cache()

    # 4. The training command with --use_style_embedding --use_gdrop --remat,
    # 128 to 256 px, then the 256 stage served with a style.
    train_dir = tempfile.mkdtemp(prefix="twingan_smoke_options_")
    try:
        stage_rows: list = []
        runners: list = []
        runner_cls = counting_runner_class(stage_rows)

        def build_runner(run_cfg, device=None):
            runners.append(runner_cls(run_cfg, device=device))
            return runners[-1]

        real_runner = pggan_runner.StageRunner
        pggan_runner.StageRunner = build_runner
        t0 = time.perf_counter()
        try:
            summary = pggan_runner.main(OPTIONS_CLI_FLAGS + [f"--train_dir={train_dir}",
                                                             f"--seed={SEED}"])
        finally:
            pggan_runner.StageRunner = real_runner
        plan_s = time.perf_counter() - t0
        (runner,) = runners
        grids = {}
        for row in stage_rows:
            strainer, _ = runner._build_trainer(row["resolution"], row["growing"], row["steps"])
            nets = strainer.build_nets()
            per_step = expected_launches(strainer, nets)
            sa = {k: sum(isinstance(mod, SelfAttention) for mod in nets[k].modules())
                  for k in (ENC, ENC_STYLE, GEN)}
            # One sample dump at the stage's last step: s2t and t2s with the
            # style encoder's styles, and the style roll with given styles.
            dump = 2 * (sa[ENC] + sa[ENC_STYLE] + sa[GEN]) + sa[ENC] + sa[GEN]
            expected = {k: row["rounds"] * (per_step["g_step"][k] + (strainer.cfg.n_critic - 1)
                                            * per_step["d_step"][k])
                        for k in per_step["g_step"]}
            expected[attention.KERNEL_NAME] += dump
            samples = os.path.join(train_dir, row["stage"], "generated_samples")
            grids[row["stage"]] = sorted(os.listdir(samples)) if os.path.isdir(samples) else []
            row.update(phase="options", program="twingan", expected_attention=expected,
                       sample_grids=grids[row["stage"]], card=card, nvidia_smi=smi_line)
            row["ok"] = bool(row["attention_launches"] == expected
                             and row["kernel_variants"] == {tc[k]: expected[k] for k in attn}
                             and not any(row["b4_launches"].values())
                             and row["nan_recoveries"] == 0
                             and f"{row['steps']}_custom_t_style_roll.png" in grids[row["stage"]])
            emit(row)
            for k in attn:
                totals[k] += row["attention_launches"][k]
        stages = [r["stage"] for r in stage_rows]
        plan = [stage_dir_name(r, g) for r, g in stage_plan(128, 256)]

        images = [np.random.RandomState(SEED + 15).randint(0, 256, (256, 256, 3))
                  .astype(np.uint8) for _ in range(TRAIN_BATCH)]
        style = torch.randn(TRAIN_BATCH, OPTIONS_STYLE_DIM,
                            generator=torch.Generator().manual_seed(SEED + 15))
        inferer = ImageInferer(train_dir)
        attention.reset_launch_counts()
        out = inferer.infer_batch(images, style=style)
        styled_launches = attention.launch_counts[attention.KERNEL_NAME]
        attention.reset_launch_counts()
        own = inferer.infer_batch(images)
        own_launches = attention.launch_counts[attention.KERNEL_NAME]
        totals[attention.KERNEL_NAME] += styled_launches + own_launches
        cpu = ImageInferer(train_dir, device="cpu", dtype="float32")
        ref = cpu.infer_batch(images, style=style)
        std = float(ref.std())
        diff = np.abs(out - ref)
        mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
        ok = (stages == plan and all(r["ok"] for r in stage_rows) and runner_losses_ok(runner)
              and summary["256"]["steps"] == OPTIONS_CLI_IMAGES // TRAIN_BATCH
              and inferer.cfg.use_style_embedding and inferer.cfg.remat
              and out.shape == (TRAIN_BATCH, 256, 256, 3) and bool(np.isfinite(out).all())
              and bool(np.isfinite(own).all()) and styled_launches == 2 and own_launches == 3
              and mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL)
        emit({"phase": "options", "check": "the training command with --use_style_embedding "
                                           "--use_gdrop --remat, 128 to 256 px; the 256 stage "
                                           "served with a given style and with its own",
              "stages": stages, "sample_grids": grids, "plan_s": plan_s,
              "stage_wall_s": {r["stage"]: r["stage_wall_s"] for r in stage_rows},
              "rounds_per_s_256": stage_rows[-1]["rounds_per_s"],
              "served_launches": {"given style": styled_launches, "own style": own_launches},
              "output_std": std, "mean_abs_err_over_std": mean_err,
              "max_abs_err_over_std": max_err, "mean_tolerance": SERVE_MEAN_TOL,
              "max_tolerance": SERVE_MAX_TOL, "seconds": time.perf_counter() - t_phase,
              "card": card, "nvidia_smi": smi_line, "ok": bool(ok)})
        if not ok:
            fail("options", "the training command with the options did not train every stage "
                            "with B1-B3's launches as its passes and dumps imply, write the "
                            "style grids, keep its losses finite, or serve its 256 stage "
                            "within serving's limits of the CPU")
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    return totals


def seeded_zoo_network(name: str, seed: int):
    """``name`` of the zoo at its reference size, in eval mode on the card,
    its kernels drawn from ``seed`` with the port's initializers, then its
    biases, batch-norm shifts and moving means moved to N(0, 0.1) and its
    scales and moving variances to U(0.5, 1.5), so that every leaf counts."""
    import torch
    from twingan_tpu_torch.models.classifiers import get_network_fn, reset_parameters

    net = get_network_fn(name, ZOO_CLASSES.get(name, 1000), image_hw=ZOO_SIZES[name]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reset_parameters(net, gen)
    with torch.no_grad():
        for key, t in net.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("bias", "mean"):
                t.normal_(0.0, 0.1, generator=gen)
            elif leaf in ("scale", "var"):
                t.uniform_(0.5, 1.5, generator=gen)
    return net.eval()


def _features_vs_cpu(fns: dict, real, fake) -> dict:
    """Features and FID of fixed images by the card's and the CPU's feature
    function (the same weights): the features' differences over the CPU
    features' std, and the two FIDs."""
    import numpy as np
    from twingan_tpu_torch.evals.metrics import frechet_distance

    out = {}
    for dev, fn in fns.items():
        f_r, f_f = (fn(x).float().cpu().numpy().astype(np.float64) for x in (real, fake))
        out[dev] = {"feats": np.concatenate([f_r, f_f]),
                    "fid": frechet_distance(f_r.mean(0), np.cov(f_r, rowvar=False),
                                            f_f.mean(0), np.cov(f_f, rowvar=False))}
    std = float(out["cpu"]["feats"].std())
    diff = np.abs(out["cuda"]["feats"] - out["cpu"]["feats"])
    return {"fid_card": out["cuda"]["fid"], "fid_cpu": out["cpu"]["fid"],
            "fid_rel_diff": abs(out["cuda"]["fid"] - out["cpu"]["fid"]) / abs(out["cpu"]["fid"]),
            "features_mean_abs_err_over_std": float(diff.mean()) / std,
            "features_max_abs_err_over_std": float(diff.max()) / std, "features_std": std}


def classifiers_phase(card: str, smi_line: str, data: dict, twingan_dir: str) -> int:
    """The classifier zoo, the tagger and FID classifier through the CLI,
    and FID and the inception score on the TwinGAN stage; returns B1's
    launches (run_eval's translations)."""
    import copy
    import math

    import numpy as np
    import torch
    from twingan_tpu_torch.data.preprocess import host_resize_uint8
    from twingan_tpu_torch.evals import metrics, run_eval
    from twingan_tpu_torch.models.grad_cam import grad_cam
    from twingan_tpu_torch.ops import attention
    from twingan_tpu_torch.runner import classifier_runner
    from twingan_tpu_torch.train.classifier_trainer import ClassifierTrainer

    t_phase = time.perf_counter()
    root = os.path.join(data["root"], "classifiers")
    os.makedirs(root, exist_ok=True)
    fwd = attention.KERNEL_NAME
    attention.reset_launch_counts()

    # 1. The zoo at reference sizes: the card against the CPU, and timed.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for name, hw in ZOO_SIZES.items():
        net = seeded_zoo_network(name, SEED)
        x = torch.rand((ZOO_TIMED_BATCH, hw, hw, 3), generator=gen, device="cuda") * 2 - 1
        small = x[:ZOO_COMPARE_BATCH]
        with torch.no_grad():
            logits = net(small)[0].float().cpu()
            cpu_net = copy.deepcopy(net).cpu()
            t0 = time.perf_counter()
            ref = cpu_net(small.cpu())[0]
            cpu_s = time.perf_counter() - t0
            del cpu_net
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: net(x), reps=ZOO_TIMED_REPS)
        err = float((logits - ref).abs().max() / ref.abs().max())
        row = {"phase": "classifiers", "network": name, "image_hw": hw,
               "num_classes": ZOO_CLASSES.get(name, 1000),
               "parameters": sum(p.numel() for p in net.parameters()),
               "ms_per_batch_32": ms, "images_per_s": ZOO_TIMED_BATCH / ms * 1e3,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "logits_rel_err_vs_cpu": err, "rtol": ZOO_RTOL, "cpu_batch_2_s": cpu_s,
               "ok": bool(err <= ZOO_RTOL and torch.isfinite(logits).all()
                          and float(ref.abs().max()) > 0),
               "card": card, "nvidia_smi": smi_line}
        emit(row)
        if not row["ok"]:
            fail("classifiers", f"{name}: the card's logits differ from the CPU's by {err} of "
                                f"their largest, over {ZOO_RTOL}")
        del net, x, small
        torch.cuda.empty_cache()

    # 2. The reference tagger through the CLI.
    tagger_dir = os.path.join(root, "tagger")
    step_times = []
    orig_step = ClassifierTrainer.train_step

    def timed_step(self, state, batch, generator=None):
        out = orig_step(self, state, batch, generator)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        return out

    ClassifierTrainer.train_step = timed_step
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        early = classifier_runner.main(["--mode=train", f"--train_dir={tagger_dir}"] + TAGGER_FLAGS
                                       + [f"--max_number_of_steps={TAGGER_EARLY_STEP}"])
        step_times.clear()
        trained = classifier_runner.main(["--mode=train", f"--train_dir={tagger_dir}"]
                                         + TAGGER_FLAGS)
        train_s = time.perf_counter() - t0
    finally:
        ClassifierTrainer.train_step = orig_step
    peak = torch.cuda.max_memory_allocated()
    lookup = os.path.join(root, "tags.txt")
    with open(lookup, "w") as f:
        f.write("".join(f"tag_{i}\n" for i in range(1539)))
    seconds, modes = {}, {}
    for mode, extra in (("eval", []), ("tags", [f"--tags_id_lookup_file={lookup}"]),
                        ("gradcam", [])):
        t0 = time.perf_counter()
        modes[mode] = classifier_runner.main([f"--mode={mode}", f"--train_dir={tagger_dir}"]
                                             + TAGGER_FLAGS + extra)
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - t0
    overlays = modes["gradcam"]["overlays"]
    # Grad-CAM of the trained state, and one more step from the early
    # checkpoint, on the card and on the CPU.
    rng = np.random.RandomState(SEED + 14)
    batch = {"image": rng.rand(TAGGER_COMPARE_BATCH, 224, 224, 3).astype(np.float32),
             "labels": (rng.rand(TAGGER_COMPARE_BATCH, 1539) > 0.9).astype(np.float32)}
    steps, maps, grads = {}, {}, {}
    for dev in ("cuda", "cpu"):
        _, state = classifier_runner.load_trained_classifier(tagger_dir, device=dev)
        net = state.net.eval()
        maps[dev] = grad_cam(lambda imgs, probes=None, net=net: net(imgs, probes=probes),
                             torch.from_numpy(batch["image"]).to(dev), "conv5").cpu()
        trainer, state = classifier_runner.load_trained_classifier(
            tagger_dir, device=dev, step=TAGGER_EARLY_STEP)
        net = state.net.eval()
        loss = trainer._loss(net(torch.from_numpy(batch["image"]).to(dev))[0],
                             torch.from_numpy(batch["labels"]).to(dev))
        grads[dev] = torch.cat([g.flatten().cpu() for g in torch.autograd.grad(
            loss, list(net.parameters()))]).double()
        before = [p.detach().cpu().clone() for p in net.parameters()]
        state, m = trainer.train_step(state, batch)
        delta = torch.cat([(p.detach().cpu() - b).flatten()
                           for p, b in zip(state.net.parameters(), before)])
        steps[dev] = (float(m["loss"]), delta.double())
        del trainer, state, net
    loss_rtol, loss_atol, cos_min, _ = TRAIN_LIMITS["float32"]
    cos = float(steps["cuda"][1] @ steps["cpu"][1]
                / (steps["cuda"][1].norm() * steps["cpu"][1].norm()))
    grad_cos = float(grads["cuda"] @ grads["cpu"] / (grads["cuda"].norm() * grads["cpu"].norm()))
    loss_diff = abs(steps["cuda"][0] - steps["cpu"][0])
    cam_err = float((maps["cuda"] - maps["cpu"]).abs().max())
    losses = early["losses"] + trained["losses"]
    rate = (len(step_times) - 1) / (step_times[-1] - step_times[0])
    tag_lines = len(open(modes["tags"]["path"]).read().splitlines())
    row = {"phase": "classifiers", "check": "the tagger through the CLI",
           "network": "illust2vec", "image_hw": 224, "num_classes": 1539, "batch": 32,
           "steps": trained["step"], "steps_per_s_after_first": rate,
           "images_per_s": rate * 32, "train_s": train_s, "peak_memory_bytes": peak,
           "first_loss": losses[0], "last_loss": losses[-1], "mode_seconds": seconds,
           "eval_metrics": modes["eval"]["metrics"], "tags_lines": tag_lines,
           "tags_images": modes["tags"]["images"], "gradcam_shape": list(overlays.shape),
           "step_vs_cpu": {"loss_card": steps["cuda"][0], "loss_cpu": steps["cpu"][0],
                           "loss_abs_diff": loss_diff, "gradient_cosine": grad_cos,
                           "update_cosine": cos, "update_cosine_min": TAGGER_UPDATE_COS,
                           "from_step": TAGGER_EARLY_STEP, "batch": TAGGER_COMPARE_BATCH},
           "gradcam_max_abs_diff_vs_cpu": cam_err, "cam_atol": CAM_ATOL,
           "card": card, "nvidia_smi": smi_line}
    row["ok"] = bool(early["step"] == TAGGER_EARLY_STEP and trained["step"] == TAGGER_STEPS
                     and len(losses) == TAGGER_STEPS and all(map(math.isfinite, losses))
                     and all(math.isfinite(v) for v in modes["eval"]["metrics"].values())
                     and modes["tags"]["images"] == 4 * 32
                     and overlays.shape == (32, 224, 224, 3) and np.isfinite(overlays).all()
                     and loss_diff <= loss_rtol * abs(steps["cpu"][0]) + loss_atol
                     and grad_cos >= cos_min and cos >= TAGGER_UPDATE_COS
                     and cam_err <= CAM_ATOL)
    emit(row)
    if not row["ok"]:
        fail("classifiers", "the tagger's CLI run gave no finite result, or its step or "
                            "Grad-CAM maps on the card disagree with the CPU's")

    # 3. The FID classifier through the CLI.
    fid_dir = os.path.join(root, "fid_classifier")
    t0 = time.perf_counter()
    fid_trained = classifier_runner.main(["--mode=train", f"--train_dir={fid_dir}"]
                                         + FID_CLASSIFIER_FLAGS)
    torch.cuda.synchronize()
    row = {"phase": "classifiers", "check": "the FID classifier through the CLI",
           "network": "cifarnet", "steps": fid_trained["step"],
           "seconds": time.perf_counter() - t0, "first_loss": fid_trained["losses"][0],
           "last_loss": fid_trained["losses"][-1],
           "ok": bool(fid_trained["step"] == 200
                      and all(map(math.isfinite, fid_trained["losses"])))}
    emit(row)
    if not row["ok"]:
        fail("classifiers", "the FID classifier's CLI run gave non-finite losses")
    if attention.launch_counts[fwd]:
        fail("classifiers", f"the classifiers launched B1 {attention.launch_counts[fwd]} times")

    # 4. FID and the inception score on the TwinGAN stage.
    tc = f"{fwd}/{attention.VARIANTS[fwd][torch.bfloat16]}"
    expected = 2 * -(-FID_IMAGES // FID_BATCH)  # encoder + generator a batch
    base = [f"--model_path={twingan_dir}", f"--dataset_dir={data['a']}",
            f"--target_dataset_dir={data['b']}", f"--seed={SEED}",
            f"--num_images={FID_IMAGES}", f"--batch_size={FID_BATCH}"]
    total = 0
    for i, (mode, extra) in enumerate((("fid", []), ("fid", [f"--classifier_path={fid_dir}"]),
                                       ("inception_score", []),
                                       ("inception_score", [f"--classifier_path={fid_dir}"]))):
        attention.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_eval.main([f"--mode={mode}", f"--eval_dir={root}/eval_{i}"] + base + extra)
        torch.cuda.synchronize()
        launches = {k: attention.launch_counts[k]
                    for k in (fwd, attention.DQ_KERNEL, attention.DKV_KERNEL)}
        value = result["fid"] if mode == "fid" else result["inception_score"]
        row = {"phase": "classifiers", "mode": mode,
               "features": "classifier" if extra else "random InceptionV3 (Mixed_5b)",
               "value": value, "images": result["images"],
               "seconds": time.perf_counter() - t0, "attention_launches": launches,
               "expected_b1": expected, "b1_tensor_core": attention.variant_counts[tc],
               "card": card, "nvidia_smi": smi_line}
        row["ok"] = bool(math.isfinite(value) and result["images"] >= FID_IMAGES
                         and launches == {fwd: expected, attention.DQ_KERNEL: 0,
                                          attention.DKV_KERNEL: 0}
                         and attention.variant_counts[tc] == expected)
        emit(row)
        if not row["ok"]:
            fail("classifiers", f"run_eval --mode={mode} gave no finite result, or B1 did "
                                "not run twice a translated batch, all tensor-core")
        total += launches[fwd]

    # 5. The card's features and FID of fixed images against the CPU's.
    def fixed(domain):
        names = sorted(data["images"][domain])[:FID_COMPARE_IMAGES]
        return np.stack([host_resize_uint8(data["images"][domain][n], "PAD", 256)
                         for n in names]).astype(np.float32) / 255.0

    real, fake = fixed("b"), fixed("a")
    for kind in ("inception", "classifier"):
        t0 = time.perf_counter()
        if kind == "inception":
            fns = {dev: metrics.inception_pool_features_fn(256, SEED, device=dev)
                   for dev in ("cuda", "cpu")}
        else:
            fns = {dev: metrics.classifier_features_fn(fid_dir, device=dev)
                   for dev in ("cuda", "cpu")}
        row = {"phase": "classifiers", "check": f"{kind} features and FID of "
                                                f"{FID_COMPARE_IMAGES} + {FID_COMPARE_IMAGES} "
                                                "fixed images, card vs CPU",
               **_features_vs_cpu(fns, real, fake), "seconds": time.perf_counter() - t0,
               "fid_rtol": FID_CARD_RTOL, "mean_tolerance": FEATURES_MEAN_TOL,
               "max_tolerance": FEATURES_MAX_TOL}
        row["ok"] = bool(row["fid_rel_diff"] <= FID_CARD_RTOL
                         and row["features_mean_abs_err_over_std"] <= FEATURES_MEAN_TOL
                         and row["features_max_abs_err_over_std"] <= FEATURES_MAX_TOL)
        emit(row)
        if not row["ok"]:
            fail("classifiers", f"the card's {kind} features or FID disagree with the CPU's")
    emit({"phase": "classifiers", "check": "the classifier zoo, its CLI, FID and IS",
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return total


def int8_bound(b: int, h: int, w: int, cin: int, cout: int, k: int, padding, dil: int,
               out_elt: int, in_elt: int = 1) -> tuple[float, str]:
    """Least time of one Q1 call: x read once (``conv_i8``: int8, channels
    padded to 4; ``conv_i8q``: the float activation, ``in_elt`` bytes an
    element, the reciprocal of its scale beside it), the weights read
    once, scale and bias (fp32) read once, the output written once; against
    the products this input needs (a dilated input's zero rows and columns
    need none: k^2 / dil^2 taps an output) at the int8 tensor-core peak."""
    from twingan_tpu_torch.ops import quant

    cp = -(-cin // 4) * 4
    ho, wo = quant.output_hw((h, w), (k, k), padding, dil)
    x_bytes = b * h * w * cp if in_elt == 1 else b * h * w * cin * in_elt + 4
    nbytes = x_bytes + cout * k * k * cp + 8 * cout + out_elt * b * cout * ho * wo
    ops = 2.0 * b * ho * wo * cout * cin * k * k / (dil * dil)
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / INT8_OPS_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def int_mm_ms(xq, wq, padding, dil):
    """``torch._int_mm`` (cuBLASLt's int8 GEMM) on the unfolded input: the
    library time of one Q1 call, the unfold not timed; None where the
    library refuses the shape."""
    import torch
    import torch.nn.functional as F

    b, h, w, cp = xq.shape
    cout, k = wq.shape[:2]
    x = xq.permute(0, 3, 1, 2).half()
    if dil > 1:
        xd = x.new_zeros(b, cp, (h - 1) * dil + 1, (w - 1) * dil + 1)
        xd[:, :, ::dil, ::dil] = x
        x = xd
    x = F.pad(x, (padding[2], padding[3], padding[0], padding[1]))
    cols = F.unfold(x, k).transpose(1, 2).reshape(-1, cp * k * k)
    kpad, npad = -cols.shape[1] % 16, -cout % 8
    a = F.pad(cols, (0, kpad)).to(torch.int8).contiguous()
    wm = wq.permute(0, 3, 1, 2).reshape(cout, -1).half()
    bm = F.pad(wm, (0, kpad, 0, npad)).to(torch.int8)
    for b_mat in (bm.t().contiguous(), bm.t()):
        try:
            torch._int_mm(a, b_mat)
        except RuntimeError:
            continue
        return device_ms(lambda: torch._int_mm(a, b_mat))
    return None


def kernel_ptxas(cout: int, in_dtype) -> list:
    """The registers and spills nvcc gave the kernel instance that a conv
    of ``cout`` output channels from ``in_dtype`` x launches
    (``conv_i8_mma_kernel<NT, in_kind>``, NT 16, 32 or 64 by Cout; the
    kernel halves NT only past 32 taps, which no conv here has), from the
    build phase."""
    from twingan_tpu_torch.ops import cuda_build, quant

    log = cuda_build.build_info.get(quant.KERNEL_NAME, {}).get("log", "")
    nt = 16 if cout <= 16 else 32 if cout <= 32 else 64
    tag = f"ILi{nt}ELi{quant.KERNEL_IN_KINDS[in_dtype]}EE"
    return [r for r in ptxas_usage(log) if "conv_i8_mma_kernel" in r["kernel"]
            and tag in r["kernel"]]


def int8_kernel_rows(shapes: dict) -> list:
    """Q1's two entries against their plain versions at each distinct conv
    shape, bit for bit: ``conv_i8`` (int8 NHWC in) and ``conv_i8q`` (the
    float activation in, bf16 and fp32, quantized as it loads; the inputs
    hold exact half-way points of x * (1 / s) and values past +-127 codes),
    each to int32, fp32 and bf16. Each entry's device time, the plain
    versions', the old path's quantize and NHWC copy (device time), both
    bounds, torch._int_mm's time and the instances' registers and spills."""
    import torch
    from twingan_tpu_torch.ops import quant

    rows = []
    cases = [(f"{name} x{n}", *shape) for shape, (name, n, _) in shapes.items()]
    cases += [INT8_UP_CASE, INT8_RAGGED_CASE]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out_types = (torch.int32, torch.float32, torch.bfloat16)
    for label, b, hw, cin, cout, k, padding, dil in cases:
        a_max = torch.tensor(3.0, device="cuda")
        s_x = quant.act_scale(a_max)
        rscale = torch.reciprocal(s_x)
        xf = torch.randn((b, cin, hw, hw), device="cuda", generator=gen)
        # Every 7th value on a half-way point (k + 0.5) s of the code grid,
        # every 11th past the clip.
        ties = (torch.randint(-127, 127, xf.shape, device="cuda", generator=gen) + 0.5) * s_x
        xf = torch.where(torch.arange(xf.numel(), device="cuda").reshape(xf.shape) % 7 == 0,
                         ties, xf)
        xf.view(-1)[::11] *= 4.0
        xq = quant.quantize(xf, s_x)
        wq = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=gen,
                           dtype=torch.int8)
        xw, ww = quant.nhwc_words(xq), quant.weight_words(wq)
        scale = torch.rand(cout, device="cuda", generator=gen) * 1e-3 + 1e-5
        bias = torch.randn(cout, device="cuda", generator=gen)
        plain = quant.conv_i8_plain(xw, ww, padding, dil)
        row = {"phase": "int8_kernel", "case": label, "B": b, "H": hw, "Cin": cin,
               "Cout": cout, "k": k, "padding": list(padding), "dilation": dil,
               "ms": {}, "launch_ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {},
               "equal": {}, "q_ms": {}, "q_plain_ms": {}, "q_bound_ms": {}, "q_bound_by": {},
               "q_equal": {}}
        for dtype in out_types:
            name = str(dtype).split(".")[1]
            sc = None if dtype == torch.int32 else scale.to(dtype).float()
            bi = None if dtype == torch.int32 else bias.to(dtype).float()
            quant.reset_launch_counts()
            got = quant.conv_i8(xw, ww, sc, bi, padding, dil, dtype)
            torch.cuda.synchronize()
            want = quant.dequantize_plain(plain, sc, bi, dtype)
            row["equal"][name] = bool(quant.launch_counts[quant.KERNEL_NAME] == 1
                                      and got.dtype == want.dtype and torch.equal(got, want))
            row["ms"][name] = device_ms(lambda: quant.conv_i8(xw, ww, sc, bi, padding, dil,
                                                              dtype))
            row["launch_ms"][name] = time_ms(lambda: quant.conv_i8(xw, ww, sc, bi, padding, dil,
                                                                   dtype))
            row["plain_ms"][name] = device_ms(lambda: quant.dequantize_plain(
                quant.conv_i8_plain(xw, ww, padding, dil), sc, bi, dtype))
            row["bound_ms"][name], row["bound_by"][name] = int8_bound(
                b, hw, hw, cin, cout, k, padding, dil, got.element_size())
            for in_type in (torch.bfloat16, torch.float32):
                x_in = xf.to(in_type)
                key = f"{str(in_type).split('.')[1]}->{name}"
                q_want = quant.dequantize_plain(quant.conv_i8_plain(
                    quant.nhwc_words(quant.quantize_recip(x_in, rscale)), ww, padding, dil),
                    sc, bi, dtype)
                quant.reset_launch_counts()
                q_got = quant.conv_i8q(x_in, rscale, ww, sc, bi, padding, dil, dtype)
                torch.cuda.synchronize()
                row["q_equal"][key] = bool(
                    quant.launch_counts[quant.FUSED_NAME] == 1 and q_got.dtype == q_want.dtype
                    and torch.equal(q_got, q_want))
                row["q_ms"][key] = device_ms(lambda: quant.conv_i8q(
                    x_in, rscale, ww, sc, bi, padding, dil, dtype))
                if dtype == torch.bfloat16:
                    row["q_plain_ms"][key] = device_ms(lambda: quant.dequantize_plain(
                        quant.conv_i8_plain(quant.nhwc_words(quant.quantize_recip(
                            x_in, rscale)), ww, padding, dil), sc, bi, dtype))
                row["q_bound_ms"][key], row["q_bound_by"][key] = int8_bound(
                    b, hw, hw, cin, cout, k, padding, dil, q_got.element_size(),
                    x_in.element_size())
        xb = xf.bfloat16()
        row["old_quantize_ms"] = device_ms(lambda: quant.nhwc_words(quant.quantize(xb, s_x)))
        row["library_ms"] = int_mm_ms(xw, ww, padding, dil)
        row["ptxas"] = {"conv_i8": kernel_ptxas(cout, torch.int8),
                        **{f"conv_i8q {str(t).split('.')[1]}": kernel_ptxas(cout, t)
                           for t in (torch.bfloat16, torch.float32)}}
        row["variant"] = quant.VARIANT
        row["ok"] = all(row["equal"].values()) and all(row["q_equal"].values())
        emit(row)
        if not row["ok"]:
            fail("int8", f"Q1 disagrees with its plain version at {label}: {row['equal']}, "
                         f"{row['q_equal']}")
        rows.append((row, shapes.get((b, hw, cin, cout, k, padding, dil), ("", 0, None))[1:]))
    return rows


def conv_shapes(inferer, x):
    """{(B, H, Cin, Cout, k, padding, dilation): (first layer, count, the
    input's dtype)} of the int8 convs one translate of ``x`` runs, read by
    forward hooks."""
    from twingan_tpu_torch.infer.quantize import quantized_convs

    shapes, hooks = {}, []

    def record(name):
        def hook(conv, args):
            xin = args[0]
            key = (xin.shape[0], xin.shape[2], xin.shape[1], conv.kernel.shape[0],
                   conv.kernel_size, conv.conv_padding(), 1)
            first, n, dtype = shapes.get(key, (name, 0, str(xin.dtype).split(".")[1]))
            shapes[key] = (first, n + 1, dtype)
        return hook

    m = inferer.model
    for name, conv in quantized_convs(m.encoder_content, m.generator):
        hooks.append(conv.register_forward_pre_hook(record(name)))
    try:
        inferer.translate(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def profiled_kernels(fn, calls: int = 3) -> dict:
    """The kernels and the copies the card ran per call of ``fn``, counted
    by torch.profiler (device activities; memcpy and memset are copies),
    after one call outside the window; None where it recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    for e in prof.events():
        if (not str(getattr(e, "device_type", "")).endswith("CUDA")
                or getattr(e, "is_user_annotation", False)):
            continue
        if "memcpy" in e.name.lower() or "memset" in e.name.lower():
            copies += 1
        else:
            kernels += 1
    if kernels == 0:
        return {"kernels": None, "copies": None}
    return {"kernels": kernels / calls, "copies": copies / calls}


def int8_trace(inferer, x, keep_io: bool = False):
    """One int8 translate of ``x``: the output on the CPU, and per conv call
    in order (name, the int8 codes of its input on the CPU, and with
    ``keep_io`` its arguments and output on the CPU)."""
    import torch
    from twingan_tpu_torch.infer.quantize import quantized_convs
    from twingan_tpu_torch.ops import quant

    calls, hooks = [], []

    def on_cpu(t):
        return t.detach().cpu() if isinstance(t, torch.Tensor) else t

    def record(name):
        def hook(conv, args, out):
            codes = quant.quantize(args[0], quant.act_scale(conv.a_max[0])).cpu()
            io = (tuple(on_cpu(a) for a in args), on_cpu(out)) if keep_io else None
            calls.append((name, codes, io))
        return hook

    m = inferer.model
    for name, conv in quantized_convs(m.encoder_content, m.generator):
        hooks.append(conv.register_forward_hook(record(name)))
    try:
        out = inferer.translate(x).float().cpu()
    finally:
        for h in hooks:
            h.remove()
    return calls, out


def int8_phase(card: str, smi_line: str) -> dict:
    """W8A8 serving of the slice config: Q1 at its shapes, the int8 path
    through BatchingLocalClient, the card against the CPU, int8 against
    bf16, and the exported programs. Returns the launches and Q1's line."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.export import export_torch, load_torch
    from twingan_tpu_torch.infer.quantize import CALIB_MIN_IMAGES, quantized_convs
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.ops import attention, fused_conv, quant
    from twingan_tpu_torch.runner.checkpoint import save_stage
    from twingan_tpu_torch.serve.clients import BatchingLocalClient

    t_phase = time.perf_counter()
    cfg = slice_config()
    root = tempfile.mkdtemp(prefix="twingan_smoke_int8_")
    try:
        stage_dir = os.path.join(root, "256")
        save_stage(stage_dir, cfg, random_translator(cfg).state_dict(), step=0)
        rng = np.random.RandomState(SEED + 8)
        images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
                  for _ in range(REQUESTS_PER_ROUND)]
        inferer = ImageInferer(stage_dir, quantize=True)  # the card, by default
        m = inferer.model
        n_convs = len(list(quantized_convs(m.encoder_content, m.generator)))
        client = BatchingLocalClient(inferer, max_batch=4, max_wait_ms=50.0)
        round_s, warm_rounds = [], 0
        try:
            with ThreadPoolExecutor(REQUESTS_PER_ROUND) as pool:
                while inferer.calibrated_images < CALIB_MIN_IMAGES:
                    list(pool.map(client.do_inference, images))
                    warm_rounds += 1
                list(pool.map(client.do_inference, images))  # int8 only from here
                torch.cuda.synchronize()
                for counts in (attention, fused_conv, quant):
                    counts.reset_launch_counts()
                dispatched = client.dispatches
                for _ in range(TIMED_ROUNDS):
                    t0 = time.perf_counter()
                    outs = list(pool.map(client.do_inference, images))
                    torch.cuda.synchronize()
                    round_s.append(time.perf_counter() - t0)
        finally:
            client.close()
        dispatches = client.dispatches - dispatched
        b1 = attention.launch_counts[attention.KERNEL_NAME]
        b1_tc = attention.variant_counts[f"{attention.KERNEL_NAME}/{attention.TENSOR_CORE}"]
        q1 = quant.launch_counts[quant.FUSED_NAME]
        q1_int8_in = quant.launch_counts[quant.KERNEL_NAME]
        for i, out in enumerate(outs):
            if out.shape != (256, 256, 3) or not np.isfinite(out).all():
                fail("int8", f"request {i}: shape {out.shape}, finite {np.isfinite(out).all()}")
        if (b1 != 2 * dispatches or b1_tc != b1 or q1 != n_convs * dispatches or q1_int8_in
                or any(fused_conv.launch_counts.values()) or dispatches < TIMED_ROUNDS * 2):
            fail("int8", f"{dispatches} batches launched B1 {b1} times ({b1_tc} tensor-core), "
                         f"conv_i8q {q1} and conv_i8 {q1_int8_in} times; expected 2, "
                         f"{n_convs} and 0 a batch, no B4: {fused_conv.launch_counts}")
        timed = sorted(round_s)[len(round_s) // 2]
        # Kernels the card runs for one frozen int8 batch of 4 and one bf16
        # batch (torch.profiler), the copies apart.
        x4 = torch.from_numpy(np.stack([inferer.preprocess(im) for im in images[:4]]))
        fp = ImageInferer(stage_dir)
        with torch.no_grad():
            per_batch = {"int8": profiled_kernels(lambda: inferer.translate(x4)),
                         "bf16": profiled_kernels(lambda: fp.translate(x4))}
        emit({"phase": "int8_serving", "warm_up_rounds": warm_rounds,
              "calibrated_images": inferer.calibrated_images, "dispatches": dispatches,
              "b1_launches": b1, "q1_launches": q1, "quantized_convs": n_convs,
              "q1_launches_by_entry": {f"{quant.FUSED_NAME}/{quant.VARIANT}": q1,
                                       f"{quant.KERNEL_NAME}/{quant.VARIANT}": q1_int8_in},
              "kernels_per_batch_of_4": per_batch,
              "images_per_s": REQUESTS_PER_ROUND / timed, "round_s": round_s,
              "bf16_serving_images_per_s": MEASURED.get("serving_images_per_s_bfloat16"),
              "card": card, "nvidia_smi": smi_line, "ok": True})
        MEASURED["int8_images_per_s"] = REQUESTS_PER_ROUND / timed
        launches = {"b1": b1, "q1": q1, "q1_int8_in": q1_int8_in}

        # Q1 at every distinct conv of a translated batch of 4.
        shapes = conv_shapes(inferer, x4)
        if sum(n for _, n, _ in shapes.values()) != n_convs:
            fail("int8", f"the hooks saw {shapes} for {n_convs} convs")
        rows = int8_kernel_rows(shapes)

        # The card against the CPU in fp32, the card's abs-maxima on both.
        a_max = {k: v.clone() for k, v in m.state_dict().items() if k.endswith("a_max")}
        x2 = x4[:INT8_CPU_BATCH]
        traces, outs, convs = {}, {}, {}
        for dev in ("cuda", "cpu"):
            inf = ImageInferer(stage_dir, device=dev, dtype="float32", quantize=True)
            inf.calibrate(x2)  # adds the buffers, switches to int8 ...
            inf.model.load_state_dict(a_max, strict=False)  # ... at the card's scales
            traces[dev], outs[dev] = int8_trace(inf, x2, keep_io=dev == "cpu")
            convs[dev] = dict(quantized_convs(inf.model.encoder_content, inf.model.generator))
        fp32 = ImageInferer(stage_dir, device="cpu", dtype="float32").translate(x2).numpy()
        # Each conv on the card given the CPU's input: bit-equal outputs.
        forced = []
        with torch.no_grad():
            for name, _, (args, want) in traces["cpu"]:
                got = convs["cuda"][name](*(a.cuda() if isinstance(a, torch.Tensor) else a
                                            for a in args))
                forced.append(bool(torch.equal(got.cpu(), want)))
        ref = outs["cpu"].numpy()
        std = float(ref.std())
        diff = np.abs(outs["cuda"].numpy() - ref)
        noise = float(np.abs(ref - fp32).mean())
        flips = [float((a[1] != b[1]).float().mean())
                 for a, b in zip(traces["cuda"], traces["cpu"])]
        vs_cpu = {"layers_bit_equal_given_the_cpu_input": sum(forced), "layers": len(forced),
                  "first_layer_flipped_share": flips[0], "second_layer_flipped_share": flips[1],
                  "flipped_share_by_layer": flips,
                  "mean_abs_err_over_std": float(diff.mean()) / std,
                  "max_abs_err_over_std": float(diff.max()) / std, "output_std": std,
                  "cpu_int8_vs_fp32_mean_abs_over_std": noise / std,
                  "second_layer_flip_tolerance": INT8_SECOND_FLIP_TOL,
                  "mean_tolerance_of_the_int8_noise": INT8_CPU_MEAN_NOISE_TOL,
                  "max_tolerance": INT8_CPU_MAX_TOL}
        ok = (all(forced) and len(forced) == n_convs and flips[0] == 0.0
              and flips[1] <= INT8_SECOND_FLIP_TOL
              and float(diff.mean()) <= INT8_CPU_MEAN_NOISE_TOL * noise
              and vs_cpu["max_abs_err_over_std"] <= INT8_CPU_MAX_TOL)
        del traces

        # int8 against bf16 on the card (information), and the exports.
        with torch.no_grad():
            y8 = inferer.translate(x4).float()
            y16 = fp.translate(x4).float()
        mse = float(torch.mean((y8 - y16) ** 2))
        vs_bf16 = {"l1": float(torch.mean(torch.abs(y8 - y16))),
                   "psnr_db": 10 * float(np.log10(1.0 / max(mse, 1e-30)))}
        exports = {}
        for name, inf in (("bf16", fp), ("int8", inferer)):
            t0 = time.perf_counter()
            path = export_torch(inf, os.path.join(root, f"export_{name}"), batch_size=4)
            t1 = time.perf_counter()
            program = load_torch(path)
            t2 = time.perf_counter()
            for counts in (attention, quant):
                counts.reset_launch_counts()
            with torch.no_grad():
                y = program(x4.cuda())
            torch.cuda.synchronize()
            got = {"b1": attention.launch_counts[attention.KERNEL_NAME],
                   "q1": quant.launch_counts[quant.FUSED_NAME],
                   "q1_int8_in": quant.launch_counts[quant.KERNEL_NAME]}
            with torch.no_grad():
                eager = inf.translate(x4)
            want_q1 = n_convs if name == "int8" else 0
            exports[name] = {"export_s": t1 - t0, "load_s": t2 - t1, "launches": got,
                             "equal_to_eager": bool(torch.equal(y, eager))}
            for key, n in got.items():
                launches[f"export_{name}_{key}"] = n
            ok = ok and exports[name]["equal_to_eager"] and got == {"b1": 2, "q1": want_q1,
                                                                    "q1_int8_in": 0}
        row = {"phase": "int8", "vs_cpu_fp32": vs_cpu, "int8_vs_bf16_on_card": vs_bf16,
               "exports": exports, "seconds": time.perf_counter() - t_phase,
               "card": card, "nvidia_smi": smi_line, "ok": bool(ok)}
        emit(row)
        if not ok:
            fail("int8", "the card's int8 path disagrees with the CPU beyond the limits, or an "
                         "exported program did not equal the eager one or missed a kernel")
        return {"launches": launches, "rows": rows, "variant": quant.VARIANT}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _max_diff(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def _states_equal(a: dict, b: dict) -> tuple[bool, float]:
    """Whether two flat states hold the same keys and bits, and their
    largest difference."""
    import torch

    if set(a) != set(b):
        return False, float("inf")
    diff = max((_max_diff(a[k], b[k]) for k in a if a[k].is_floating_point()), default=0.0)
    return all(torch.equal(a[k], b[k]) for k in a), diff


def _under_group(group, fn):
    """``fn()`` with ``group`` registered (None: no group)."""
    from twingan_tpu_torch import parallel

    prev = parallel.current_group()
    parallel.set_current_group(group)
    try:
        return fn()
    finally:
        parallel.set_current_group(prev)


def _parallel_core_checks(group) -> list:
    """The context-parallel attention core on the card at one process
    (all-to-all, all-gather, the core, all-to-all back; forward and
    backward) bit-equal to the local ``self_attention``, B1-B3 once each;
    then the per-process core at PARALLEL_SPLIT processes' split of the
    keys, each block through B1-B3, against autograd of the plain version
    in fp32."""
    import torch
    from twingan_tpu_torch.ops import attention

    rows = []
    one_each = {attention.KERNEL_NAME: 1, attention.DQ_KERNEL: 1, attention.DKV_KERNEL: 1,
                attention.PLAIN_ROUTE: 0}
    for label, b, n, c_bar, c, dtype in PARALLEL_CORE_CASES:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        dt = getattr(torch, dtype)
        inputs = [torch.randn(b, n, k, generator=gen, device="cuda").to(dt)
                  for k in (c_bar, c_bar, c)]
        do = torch.randn(b, n, c, generator=gen, device="cuda").to(dt)

        def run(fn):
            leaves = [t.clone().requires_grad_(True) for t in inputs]
            torch.cuda.synchronize()
            attention.reset_launch_counts()
            o = fn(*leaves)
            o.backward(do)
            torch.cuda.synchronize()
            return o.detach(), [t.grad for t in leaves], dict(attention.launch_counts)

        o_cp, g_cp, counts = run(lambda f, g, h: attention.context_parallel_attention(
            f, g, h, group))
        o_local, g_local, _ = run(attention.self_attention)
        equal = torch.equal(o_cp, o_local) and all(map(torch.equal, g_cp, g_local))
        rows.append({"check": f"context-parallel core, {label}", "shape": [b, n, c_bar, c],
                     "dtype": dtype, "bit_equal": equal,
                     "max_diff": max([_max_diff(o_cp, o_local)]
                                     + [_max_diff(x, y) for x, y in zip(g_cp, g_local)]),
                     "launches": counts, "expected_launches": one_each,
                     "ok": bool(equal and counts == one_each)})

        # PARALLEL_SPLIT processes' share: its query rows against every key,
        # the keys in PARALLEL_SPLIT blocks.
        q = n // PARALLEL_SPLIT
        f, g, h = (t.clone().requires_grad_(True) for t in inputs)
        fq = f[:, :q].contiguous()
        torch.cuda.synchronize()
        attention.reset_launch_counts()
        o = attention.self_attention(fq, g, h, blocks=PARALLEL_SPLIT)
        o.backward(do[:, :q])
        torch.cuda.synchronize()
        counts = dict(attention.launch_counts)
        ref_in = [t.detach().float().requires_grad_(True) for t in (fq, g, h)]
        o_ref = attention.attention_core(*ref_in)
        df_ref, dg_ref, dh_ref = torch.autograd.grad(o_ref, ref_in, do[:, :q].float())
        errs = {"o": _max_diff(o, o_ref), "df": _max_diff(f.grad[:, :q], df_ref),
                "dg": _max_diff(g.grad, dg_ref), "dh": _max_diff(h.grad, dh_ref)}
        limits = {"o": tolerance(dtype, float(o_ref.abs().max())),
                  **{k: grad_tolerance(dtype, float(ref.abs().max()), n)
                     for k, ref in (("df", df_ref), ("dg", dg_ref), ("dh", dh_ref))}}
        split_counts = {k: PARALLEL_SPLIT * v for k, v in one_each.items()}
        rows.append({"check": f"per-process core at {PARALLEL_SPLIT} processes, {label}",
                     "shape": [b, q, n, c_bar, c], "dtype": dtype, "max_abs_err": errs,
                     "limits": limits, "launches": counts, "expected_launches": split_counts,
                     "ok": bool(all(errs[k] <= limits[k] for k in errs)
                                and counts == split_counts)})
    return rows


def _parallel_round(trainer, make_state, batches, group):
    """One round from a fresh state, with ``group`` registered or none:
    (flat state after it, metrics, attention launches, B4 launches)."""
    import torch
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.train.state import state_to_dict

    def run():
        state = make_state()
        torch.cuda.synchronize()
        attention.reset_launch_counts()
        fused_conv.reset_launch_counts()
        state, metrics = trainer.round_step(state, batches, rng=SEED)
        torch.cuda.synchronize()
        flat = {k: v.detach().clone() for k, v in state_to_dict(state).items()}
        return (flat, {k: float(v) for k, v in metrics.items()},
                dict(attention.launch_counts), dict(fused_conv.launch_counts))

    return _under_group(group, run)


def parallel_phase(card: str, smi_line: str) -> dict:
    """The multi-device training path (``twingan_tpu_torch.parallel``) over
    a real NCCL process group of one process on the card, which must
    initialize (no gloo, no fallback): the context-parallel attention core
    called directly; one round of the TwinGAN slice config (256 px, batch
    3) with ``attention_context_parallel`` and synced batch norm (the
    attention layers take the local path at one process, as the JAX layer
    does on a mesh of one device: the core runs only in the direct
    checks), and one
    pggan256 round (batch 12), each under the group against the same round
    without it (parameters, EMAs, optimizer slots and metrics bit-equal;
    B1-B3 as ``expected_launches`` says, 13 B4 launches a D step); and a
    ``StageRunner`` plan under the group (pggan256 4 -> 16 px,
    ``num_devices=1``, in two calls on one train dir: the first process
    writes as the coordinator, the second call resumes). Returns the
    launches of the path's runs under the group, by kernel."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from twingan_tpu_torch import parallel
    from twingan_tpu_torch.ops import attention, fused_conv
    from twingan_tpu_torch.runner.checkpoint import CheckpointManager
    from twingan_tpu_torch.runner.stage_runner import (
        PGGAN_BATCH_SCHEDULE,
        RunConfig,
        stage_dir_name,
        stage_plan,
    )
    from twingan_tpu_torch.train.gan_trainer import GanTrainer
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    t_phase = time.perf_counter()
    try:
        group = parallel.init_group("cuda", 0, 1, f"tcp://127.0.0.1:{_free_port()}",
                                    timeout_s=300)
    except Exception as e:  # the phase's own failure, named
        fail("parallel", f"no NCCL process group on the card: {type(e).__name__}: {e}")
    backend = dist.get_backend(group)
    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    # Each round runs twice and the two must agree bit for bit: cuDNN's
    # deterministic algorithms only.
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    launches: dict = {}
    rows: list = []
    try:
        if backend != "nccl" or parallel.world_size(group) != 1:
            fail("parallel", f"the group is {backend} over {parallel.world_size(group)} "
                             "process(es), not NCCL over one")
        t0 = time.perf_counter()
        rows += _parallel_core_checks(group)
        core_s = time.perf_counter() - t0

        def add(counts: dict) -> None:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v

        # The TwinGAN slice config with both options, one round.
        t0 = time.perf_counter()
        base = slice_config()
        cfg = train_config(base.replace(model=base.model.replace(
            attention_context_parallel=True, sync_batch_norm_axis="data")))
        trainer = TwinGANTrainer(cfg)
        rng = np.random.RandomState(SEED + 11)
        batches = [_train_batch(rng, cfg, "cuda") for _ in range(cfg.n_critic)]

        def twingan_state():
            state = trainer.init_state(SEED)
            set_attention_gamma(state.nets)
            return state

        ref = _parallel_round(trainer, twingan_state, batches, None)
        got = _parallel_round(trainer, twingan_state, batches, group)
        per_step = expected_launches(trainer, trainer.build_nets())
        expected = {k: per_step["g_step"][k] + (cfg.n_critic - 1) * per_step["d_step"][k]
                    for k in per_step["g_step"]}
        equal, diff = _states_equal(got[0], ref[0])
        rows.append({"check": "TwinGAN slice round (synced batch norm, the gradient and "
                              "metric all-reduces; attention_context_parallel set, "
                              "attention on the local path at one process) under the "
                              "group against no group",
                     "batch": TRAIN_BATCH, "state_bit_equal": equal, "state_max_diff": diff,
                     "metrics_equal": got[1] == ref[1], "launches": got[2],
                     "expected_launches": expected, "b4_launches": got[3],
                     "seconds": time.perf_counter() - t0,
                     "ok": bool(equal and got[1] == ref[1] and got[2] == expected
                                and ref[2] == expected and not any(got[3].values())
                                and all(np.isfinite(v) for v in got[1].values()))})
        add(got[2])

        # pggan256, one round: B4 in the D step's generator pass.
        t0 = time.perf_counter()
        gcfg = generation_config()
        gtrainer = GanTrainer(gcfg)
        grng = np.random.RandomState(SEED + 12)
        gbatches = [{"target": torch.from_numpy(grng.rand(GEN_BATCH, 256, 256, 3)
                                                .astype("float32")).cuda()}
                    for _ in range(gcfg.n_critic)]

        def pggan_state():
            state = gtrainer.init_state(SEED)
            randomize_biases(state.nets, SEED)
            return state

        gref = _parallel_round(gtrainer, pggan_state, gbatches, None)
        ggot = _parallel_round(gtrainer, pggan_state, gbatches, group)
        gexpected = {fused_conv.KERNEL_NAME: GEN_LAYERS_PER_PASS * (gcfg.n_critic - 1),
                     fused_conv.AUTOGRAD_ROUTE: GEN_LAYERS_PER_PASS}
        equal, diff = _states_equal(ggot[0], gref[0])
        rows.append({"check": "pggan256 round under the group against no group",
                     "batch": GEN_BATCH, "state_bit_equal": equal, "state_max_diff": diff,
                     "metrics_equal": ggot[1] == gref[1], "b4_launches": ggot[3],
                     "expected_b4_launches": gexpected, "seconds": time.perf_counter() - t0,
                     "ok": bool(equal and ggot[1] == gref[1] and ggot[3] == gexpected
                                and gref[3] == gexpected)})
        add(ggot[3])

        # The stage runner under the group, in two calls on one train dir.
        t0 = time.perf_counter()
        train_dir = tempfile.mkdtemp(prefix="twingan_smoke_parallel_")
        try:
            run_cfg = RunConfig(program="image_generation", train_dir=train_dir, start_hw=4,
                                max_hw=16, num_images_per_resolution=PARALLEL_PLAN_IMAGES,
                                use_synthetic_data=True, trainer=gcfg, log_every_n_steps=1,
                                save_every_n_steps=1, keep_checkpoints=2,
                                log_image_every_n_iter=0, num_devices=1, seed=SEED)
            plan = [stage_dir_name(r, g) for r, g in stage_plan(4, 16)]
            stage_rows: list = []

            def plan_run():
                return [counting_runner(c, stage_rows).run() for c in (
                    run_cfg.replace(max_stages_per_run=PARALLEL_FIRST_CALL_STAGES), run_cfg)]

            summaries = _under_group(group, plan_run)
            rounds = PARALLEL_PLAN_IMAGES // PGGAN_BATCH_SCHEDULE[16]
            b4_expected = [rounds * (gcfg.n_critic - 1) * (1 + 2 * int(np.log2(r["resolution"]
                                                                             // 4)))
                           for r in stage_rows]
            b4_seen = [r["b4_launches"][fused_conv.KERNEL_NAME] for r in stage_rows]
            skipped = [t for t in plan if summaries[1].get(t, {}).get("skipped")]
            written = all(os.path.isfile(os.path.join(train_dir, t, n)) for t in plan
                          for n in ("config.json", "model.pt"))
            final = [CheckpointManager(os.path.join(train_dir, t)).latest_step() for t in plan]
            rows.append({"check": "StageRunner plan under the group, pggan256 4 -> 16 px, "
                                  "two calls", "stages": [r["stage"] for r in stage_rows],
                         "first_call_incomplete": bool(summaries[0].get("_incomplete")),
                         "second_call_skipped": skipped, "files_written": written,
                         "final_steps": final, "b4_launches": b4_seen,
                         "expected_b4_launches": b4_expected,
                         "seconds": time.perf_counter() - t0,
                         "ok": bool(summaries[0].get("_incomplete") and written
                                    and skipped == plan[:PARALLEL_FIRST_CALL_STAGES]
                                    and [r["stage"] for r in stage_rows] == plan
                                    and final == [rounds] * len(plan)
                                    and b4_seen == b4_expected)})
            for r in stage_rows:
                add(r["attention_launches"])
                add(r["b4_launches"])
        finally:
            shutil.rmtree(train_dir, ignore_errors=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        parallel.set_current_group(None)
        dist.destroy_process_group()
    for row in rows:
        emit({"phase": "parallel", **row})
    path = {k: launches.get(k, 0) for k in (attention.KERNEL_NAME, attention.DQ_KERNEL,
                                             attention.DKV_KERNEL, fused_conv.KERNEL_NAME)}
    emit({"phase": "parallel", "check": "summary", "backend": backend, "nccl": nccl,
          "world_size": 1, "core_seconds": core_s,
          "max_diff": {r["check"]: r.get("max_diff", r.get("state_max_diff",
                                                            r.get("max_abs_err")))
                       for r in rows if "core" in r["check"] or "round" in r["check"]},
          "launches": path, "seconds": time.perf_counter() - t_phase, "card": card,
          "nvidia_smi": smi_line, "ok": all(r["ok"] for r in rows)})
    bad = [r["check"] for r in rows if not r["ok"]]
    if bad:
        fail("parallel", f"failed: {bad}")
    return path


def _alt_seed_norms(nets, seed: int) -> None:
    """Biases, norm scales and biases and running moments drawn from
    ``seed``, so that eval mode reads moments other than 0 and 1."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, t in nets.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif leaf in ("bias", "mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)


def _alt_forward_row(check: str, card_out, cpu_out, **more) -> dict:
    import torch

    card_out, cpu_out = card_out.float().cpu(), cpu_out.float()
    ref_max = float(cpu_out.abs().max())
    diff = float((card_out - cpu_out).abs().max())
    limit = ALT_FORWARD_TOL * max(1.0, ref_max)
    return {"phase": "alt_gans", "check": check, "max_abs_diff": diff, "limit": limit,
            "ref_max": ref_max, "shape": list(card_out.shape), **more,
            "ok": bool(torch.isfinite(card_out).all()) and diff <= limit}


def _alt_timed_rounds(trainer, state, batches) -> dict:
    """rounds/s of ``ALT_TIMED_ROUNDS`` rounds on the card after one warm-up
    round (the trainer's own draws), and the peak memory they held. The
    losses stay on the card until the window has ended."""
    import torch

    losses = []
    for i in range(ALT_TIMED_ROUNDS + 1):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        state, metrics = trainer.round_step(state, batches, rng=i)
        losses += [metrics["generator_loss"], metrics["discriminator_loss"]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"rounds": ALT_TIMED_ROUNDS, "seconds": seconds,
            "rounds_per_s": ALT_TIMED_ROUNDS / seconds,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "losses_finite": bool(torch.isfinite(torch.stack(
                [torch.as_tensor(v, dtype=torch.float32).reshape(()).cpu()
                 for v in losses])).all())}


def _alt_trainer_rows(device: str, cfg, batches, zs, gp_noise, sample_input, name: str,
                      zero_grads=None):
    """One network through ``GanTrainer``: its G and D step on the card
    against the CPU (``compare_steps``, with ``zero_grads``), ``sample`` of
    the seeded weights on both, and its timed rounds on the card."""
    import torch
    from twingan_tpu_torch.models.layers import reset_parameters
    from twingan_tpu_torch.train.gan_trainer import GanTrainer

    nets = GanTrainer(cfg, device="cpu").build_nets()
    reset_parameters(nets, torch.Generator().manual_seed(SEED))
    _alt_seed_norms(nets, SEED + 1)
    weights = {k: v.clone() for k, v in nets.state_dict().items()}
    rows = compare_steps(cfg, weights, batches, gp_noise, card=device, trainer_cls=GanTrainer,
                         zs=zs, phase="alt_gans",
                         limits={"float32": TRAIN_LIMITS["float32"][:3] + (None,)},
                         zero_grads=zero_grads)
    for r in rows:
        r["check"] = f"{name}: {r['check']}"
    outs = {}
    for where in ("cpu", device):
        trainer = GanTrainer(cfg, device=where)
        state = trainer.state_from_nets(trainer.build_nets())
        state.nets.load_state_dict(weights)
        outs[where] = trainer.sample(state, sample_input)
    rows.append(_alt_forward_row(f"{name}: sample (eval mode), card vs CPU", outs[device],
                                 outs["cpu"]))
    trainer = GanTrainer(cfg, device=device)
    state = trainer.state_from_nets(trainer.build_nets())
    state.nets.load_state_dict(weights)
    card_batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
    timed = _alt_timed_rounds(trainer, state, card_batches)
    rows.append({"phase": "alt_gans", "check": f"{name}: timed rounds on the card", **timed,
                 "batch": cfg.batch_size, "ok": timed["losses_finite"]})
    return rows, timed


def _alt_module_rows(device: str) -> list:
    """The CycleGAN generator alone at 9 blocks in each decoder, and
    pix2pix's G and D in eval and train mode (given dropout masks), each
    on the card against the CPU."""
    import torch
    from twingan_tpu_torch.models.cyclegan import UPSAMPLE_METHODS, CycleGANGenerator
    from twingan_tpu_torch.models.layers import reset_parameters
    from twingan_tpu_torch.models.pix2pix import Pix2PixDiscriminator, Pix2PixGenerator

    rows = []
    gen = torch.Generator().manual_seed(SEED + 2)
    c = ALT_CYCLEGAN
    x = torch.rand(c["batch"], c["resolution"], c["resolution"], 3, generator=gen)
    for method in UPSAMPLE_METHODS:
        net = CycleGANGenerator(num_filters=c["filters"], num_resnet_blocks=c["blocks_alone"],
                                upsample_method=method)
        reset_parameters(net, torch.Generator().manual_seed(SEED))
        _alt_seed_norms(net, SEED + 1)
        with torch.no_grad():
            cpu_out = net(x)
            card_out = net.to(device)(x.to(device))
        rows.append(_alt_forward_row(f"cyclegan generator, {c['blocks_alone']} blocks, "
                                     f"{method}", card_out, cpu_out))
    p = ALT_PIX2PIX
    x = torch.rand(p["batch"], p["resolution"], p["resolution"], 3, generator=gen) * 2 - 1
    g = Pix2PixGenerator(base_filters=p["base"], input_size=p["resolution"])
    d = Pix2PixDiscriminator(base_filters=p["base"])
    for net in (g, d):
        reset_parameters(net, torch.Generator().manual_seed(SEED))
        _alt_seed_norms(net, SEED + 1)
    masks = [torch.rand(s, generator=gen) < 0.5 for s in g.dropout_shapes(p["batch"])]
    for mode in ("eval", "train"):
        outs = {}
        for where in ("cpu", device):
            g.to(where).train(mode == "train")
            d.to(where).train(mode == "train")
            kw = {"dropout_masks": [m.to(where) for m in masks]} if mode == "train" else {}
            with torch.no_grad():
                fake = g(x.to(where), **kw)
                pred = d(torch.cat([x.to(where), fake], dim=-1))
            outs[where] = (fake, pred)
        rows.append(_alt_forward_row(f"pix2pix generator, {mode} mode", outs[device][0],
                                     outs["cpu"][0]))
        rows.append(_alt_forward_row(f"pix2pix discriminator, {mode} mode", outs[device][1],
                                     outs["cpu"][1]))
    return rows


def _alt_runner_row(cfg) -> dict:
    """The DCGAN through ``StageRunner``: one fixed 64 px stage of
    ``ALT_RUNNER_ROUNDS`` rounds on synthetic data, with its sample grid and
    in-training SWD every ``ALT_RUNNER_EVERY`` steps."""
    from twingan_tpu_torch.runner.stage_runner import RunConfig

    res, batch = cfg.model.resolution, cfg.batch_size
    train_dir = tempfile.mkdtemp(prefix="twingan_smoke_dcgan_")
    try:
        run_cfg = RunConfig(program="image_generation", train_dir=train_dir, start_hw=res,
                            max_hw=res, num_images_per_resolution=ALT_RUNNER_ROUNDS * batch,
                            batch_schedule={res: batch}, use_synthetic_data=True, trainer=cfg,
                            log_every_n_steps=1, save_every_n_steps=ALT_RUNNER_ROUNDS,
                            log_image_every_n_iter=ALT_RUNNER_EVERY,
                            eval_every_n_iter_in_training=ALT_RUNNER_EVERY)
        stage_rows: list = []
        t0 = time.perf_counter()
        runner = counting_runner(run_cfg, stage_rows)
        summary = runner.run()
        stage_dir = os.path.join(train_dir, str(res))
        steps = list(range(ALT_RUNNER_EVERY, ALT_RUNNER_ROUNDS + 1, ALT_RUNNER_EVERY))
        grids = all(os.path.isfile(os.path.join(stage_dir, "generated_samples", f"{s}.png"))
                    for s in steps)
        row = stage_rows[0] if stage_rows else {}
        return {"phase": "alt_gans", "check": f"dcgan StageRunner, one {res} px stage",
                "steps": summary.get(str(res), {}).get("steps"), "sample_grids": grids,
                "swd_in_training": swd_files_ok(stage_dir, steps),
                "model_pt": os.path.isfile(os.path.join(stage_dir, "model.pt")),
                "rounds_per_s": row.get("rounds_per_s"),
                "peak_memory_bytes": row.get("peak_memory_bytes"),
                "parts_s": row.get("parts_s"), "seconds": time.perf_counter() - t0,
                "ok": bool(summary.get(str(res), {}).get("steps") == ALT_RUNNER_ROUNDS
                           and grids and swd_files_ok(stage_dir, steps)
                           and runner_losses_ok(runner))}
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)


def _alt_import_row(device: str) -> dict:
    """The TF1 import mapping without TensorFlow: every name of
    ``export_var_names`` over the TwinGAN slice config's weights maps back
    to its leaf; the arrays, routed through ``map_tf_arrays`` into a fresh
    translator, give the original weights bit for bit and serve one 256 px
    batch bit-equal to the original's on the card."""
    import numpy as np
    import torch
    from twingan_tpu_torch import bridge
    from twingan_tpu_torch.infer import import_tf
    from twingan_tpu_torch.train.twingan_trainer import ENC, GEN, translate

    cfg = slice_config()
    original = random_translator(cfg)
    params, model_state = bridge.flax_train_state(original.state_dict(), (ENC, GEN))
    names = import_tf.export_var_names({"params": params, "model_state": model_state})
    round_trip = all(import_tf.map_var_name(n) == t for n, t in names.items())
    arrays = {}
    for name, (net, path, collection) in names.items():
        node = params[net] if collection is None else model_state[net][collection]
        for k in path:
            node = node[k]
        arrays[name] = node.reshape(1, -1) if name.endswith("/u") else node
    fresh = type(original)(cfg)
    fresh_params, fresh_state = bridge.flax_train_state(fresh.state_dict(), (ENC, GEN))
    tree, report = import_tf.map_tf_arrays(arrays, {"params": fresh_params,
                                                    "model_state": fresh_state}, strict=True)
    fresh.load_state_dict(bridge.train_state_dict(tree["params"], tree["model_state"],
                                                  (ENC, GEN)), strict=True)
    weights_equal = all(torch.equal(a, fresh.state_dict()[k])
                        for k, a in original.state_dict().items())
    x = torch.from_numpy(np.random.RandomState(SEED).rand(
        ALT_IMPORT_BATCH, cfg.model.resolution, cfg.model.resolution, 3).astype("float32"))
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        outs = []
        for model in (original, fresh):
            model.to(device).eval()
            outs.append(translate(cfg, model.encoder_content, model.generator, x.to(device)))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    served_equal = bool(torch.equal(outs[0], outs[1]))
    return {"phase": "alt_gans", "check": "TF1 import mapping of the TwinGAN slice config "
            "(no TensorFlow), served at 256 px", "names": len(names),
            "mapped": len(report["mapped"]), "names_map_back": round_trip,
            "weights_bit_equal": weights_equal, "served_bit_equal": served_equal,
            "batch": ALT_IMPORT_BATCH,
            "ok": bool(round_trip and weights_equal and served_equal
                       and len(report["mapped"]) == len(names))}


def alt_gans_phase(card: str, smi_line: str, device: str = "cuda") -> dict:
    """DCGAN and CycleGAN through ``GanTrainer`` (a G and a D step against
    the CPU, ``sample``, timed rounds), DCGAN through ``StageRunner``, the
    CycleGAN generator alone in its three decoders, pix2pix, then the TF1
    import mapping (module constants above). The alternative networks run
    none of the kernels: every launch count stays 0 through them. The
    import check serves the slice config, whose attention runs B1; its
    launches are returned. ``card`` is the card's name, ``device`` where
    the card's side runs."""
    import numpy as np
    import torch
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.ops import attention, fused_conv, quant
    from twingan_tpu_torch.train.gan_trainer import DIS, GanTrainer, GanTrainerConfig

    def counts():
        return {**attention.launch_counts, **fused_conv.launch_counts, **quant.launch_counts}

    def reset():
        for m in (attention, fused_conv, quant):
            m.reset_launch_counts()

    t_phase = time.perf_counter()
    rs = np.random.RandomState(SEED)
    rows, timed = [], {}
    reset()
    d = ALT_DCGAN
    dcgan = GanTrainerConfig(model=PGGANConfig(resolution=d["resolution"]),
                             generator_network="dcgan", dcgan_depth=d["depth"],
                             dcgan_latent_dim=d["latent"], batch_size=d["batch"])
    hw, b = d["resolution"], d["batch"]
    images = lambda n, h: torch.from_numpy(rs.rand(n, h, h, 3).astype("float32"))  # noqa: E731
    latents = {k: torch.from_numpy(rs.randn(b, d["latent"]).astype("float32"))
               for k in ("g_step", "d_step")}
    gp = {"alpha": torch.from_numpy(rs.rand(b, 1, 1, 1).astype("float32")),
          "noise": torch.from_numpy((rs.rand(b, hw, hw, 3) * 2 - 1).astype("float32"))}
    new, timed["dcgan"] = _alt_trainer_rows(
        device, dcgan, [{"target": images(b, hw)} for _ in range(2)], latents, gp,
        torch.from_numpy(rs.randn(16, d["latent"]).astype("float32")), "dcgan")
    rows += new
    c = ALT_CYCLEGAN
    cyclegan = GanTrainerConfig(model=PGGANConfig(resolution=c["resolution"]),
                                generator_network="cyclegan",
                                cyclegan_num_channels=c["filters"], batch_size=c["batch"])
    hw, b = c["resolution"], c["batch"]
    gp = {"alpha": torch.from_numpy(rs.rand(b, 1, 1, 1).astype("float32")),
          "noise": torch.from_numpy((rs.rand(b, hw, hw, 3) * 2 - 1).astype("float32"))}
    blocks = GanTrainer(cyclegan, device="cpu").build_nets()[DIS].num_blocks
    new, timed["cyclegan"] = _alt_trainer_rows(
        device, cyclegan, [{"source": images(b, hw), "target": images(b, hw)} for _ in range(2)],
        None, gp, images(b, hw), "cyclegan",
        zero_grads={"d_step": tuple(f"block_{i}_conv0" for i in range(blocks))})
    rows += new
    rows += _alt_module_rows(device)
    rows.append(_alt_runner_row(dcgan))
    alt_counts = counts()
    rows.append({"phase": "alt_gans", "check": "no kernel launched by the alternative "
                 "networks", "launches": alt_counts,
                 "ok": not any(alt_counts.values())})
    reset()
    rows.append(_alt_import_row(device))
    import_counts = counts()
    for row in rows:
        emit(row)
    summary = {
        "phase": "alt_gans", "check": "summary", "seconds": time.perf_counter() - t_phase,
        "rounds_per_s": {k: v["rounds_per_s"] for k, v in timed.items()},
        "peak_memory_bytes": {k: v["peak_memory_bytes"] for k, v in timed.items()},
        "max_diff": {r["check"]: r.get("max_abs_diff", r.get("loss_abs_err"))
                     for r in rows if "max_abs_diff" in r or "loss_abs_err" in r},
        "grad_cosine": {r["check"]: r["grad_cosine"] for r in rows if "grad_cosine" in r},
        "import_serving_launches": import_counts, "card": card, "nvidia_smi": smi_line,
        "ok": all(r["ok"] for r in rows)}
    emit(summary)
    bad = [r["check"] for r in rows if not r["ok"]]
    if bad:
        fail("alt_gans", f"failed: {bad}")
    return import_counts


def wide_configs():
    """The configurations of the wide phase: (the TwinGAN slice config at
    the published PGGAN's 512 channels with attention at 8 px; the same at
    1024 channels with attention at 4 px in the generator; pggan256 with
    every layer 2048 channels wide, cut to 32 px)."""
    cfg = slice_config()
    w512 = cfg.replace(model=cfg.model.replace(max_channels=512, self_attention_hw=8))
    w1024 = cfg.replace(model=cfg.model.replace(max_channels=1024, self_attention_hw=4))
    gen = generation_config(WIDE_GEN_BATCH)
    w2048 = gen.replace(model=gen.model.replace(min_channels=2048,
                                                resolution=WIDE_GEN_RESOLUTION))
    return w512, w1024, w2048


def _serve_vs_cpu(phase: str, cfg, root: str, name: str, batches: dict, per_batch: int,
                  images) -> dict:
    """Serve ``batches[dtype]`` batches of 4 of a random translator of
    ``cfg`` on the card in each type, counting B1's launches (``per_batch``
    a batch, each on its type's variant only), and hold each type's first
    image against fp32 on the CPU within the serving phase's tolerances of
    that type (SERVE_TOLS)."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.ops import attention
    from twingan_tpu_torch.runner.checkpoint import save_stage

    stage_dir = os.path.join(root, name)
    save_stage(stage_dir, cfg, random_translator(cfg).state_dict(), step=0)
    ref = ImageInferer(stage_dir, device="cpu", dtype="float32").infer_batch(images[:1])[0]
    std = float(ref.std())
    fwd = attention.KERNEL_NAME
    launches = {}
    for dtype, count in batches.items():
        inferer = ImageInferer(stage_dir, dtype=dtype)  # the card, by default
        attention.reset_launch_counts()
        outs = [inferer.infer_batch(images) for _ in range(count)]
        torch.cuda.synchronize()
        launches[dtype] = attention.launch_counts[fwd]
        variants = {k: v for k, v in attention.variant_counts.items() if v}
        diff = np.abs(outs[0][0] - ref)
        mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
        mean_tol, max_tol = SERVE_TOLS[dtype]
        want = f"{fwd}/{attention.VARIANTS[fwd][getattr(torch, dtype)]}"
        row = {"phase": phase, "check": f"serve {name}, card {dtype} vs CPU float32",
               "batches": count, "batch": len(images), "kernel_launches": launches[dtype],
               "expected_launches": per_batch * count, "kernel_variants": variants,
               "output_std": std, "mean_abs_err_over_std": mean_err,
               "max_abs_err_over_std": max_err, "mean_tolerance": mean_tol,
               "max_tolerance": max_tol,
               "ok": bool(all(o.shape == (len(images), *ref.shape) and np.isfinite(o).all()
                              for o in outs)
                          and launches[dtype] == per_batch * count
                          and variants == {want: launches[dtype]}
                          and mean_err <= mean_tol and max_err <= max_tol)}
        emit(row)
        if not row["ok"]:
            fail(phase, f"serving {name} in {dtype} disagrees with the CPU or launched B1 "
                        f"other than {per_batch} times a batch on its variant {want}")
        del inferer, outs
    return {"launches": sum(launches.values()), "stage_dir": stage_dir}


def wide_phase(card: str, smi_line: str) -> dict:
    """Every channel width the JAX package runs, on the kernels (depths
    as listed; widths as the configurations give them):
    - the slice config at 512 channels, attention at 8 px (C 512, c_bar 64,
      N 64 in the encoder, the generator and both discriminators): 2
      batches of 4 served in bf16 and one in fp32 (B1; fp32 on the wide
      3xTF32 kernel, past C 256), one training round at batch 3 on the card
      (B1-B3) with its launches counted, a G and a D step in fp32 and in
      bf16 against fp32 on the CPU (cut to 16 px: the attention layer's
      shape is the same; the fp32 steps' B1-B3 launches counted, every one
      on the wide 3xTF32 kernel), and one batch served in int8 (Q1's
      conv_i8q at 512 channels), each conv given the CPU's input bit-equal
      to the CPU's;
    - the slice config at 1024 channels, attention at 4 px in the
      generator (C 1024, c_bar 128, N 16): one batch of 4 served;
    - pggan256 with min_channels 2048, cut to 32 px: a D step and a
      ``sample``, each generator pass 7 launches of B4 at Cout 2048, each
      one kernel (8 channel tiles of 256 in one cluster, its one-pass
      route), the sample against fp32 on the CPU, and a bf16 D step against
      the CPU at 16 px.
    Returns each kernel's launches on these paths."""
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.quantize import quantized_convs
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.models.pggan import noise_shape
    from twingan_tpu_torch.ops import attention, fused_conv, quant
    from twingan_tpu_torch.train.gan_trainer import GanTrainer
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    t_phase = time.perf_counter()
    w512, w1024, w2048 = wide_configs()
    fwd, dq, dkv = attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL
    launches = {fwd: 0, dq: 0, dkv: 0, fused_conv.KERNEL_NAME: 0, quant.FUSED_NAME: 0}
    rows, seconds = [], {}
    rng = np.random.RandomState(SEED + 11)
    res = w512.model.resolution
    images = [rng.randint(0, 256, (res, res, 3)).astype(np.uint8) for _ in range(4)]
    root = tempfile.mkdtemp(prefix="twingan_smoke_wide_")
    try:
        # 512 channels: serving.
        t0 = time.perf_counter()
        served = _serve_vs_cpu("wide", w512, root, "512",
                               {"bfloat16": WIDE_SERVE_BATCHES, "float32": 1}, 2, images)
        launches[fwd] += served["launches"]
        seconds["serve_512"] = time.perf_counter() - t0

        # 512 channels: a G and a D step against the CPU (16 px), then one
        # round on the card at 256 px with its launches counted.
        t0 = time.perf_counter()
        small = train_config(w512.replace(model=w512.model.replace(
            resolution=WIDE_COMPARE_RESOLUTION)))
        trainer = TwinGANTrainer(small, device="cpu")
        state = trainer.init_state(SEED)
        set_attention_gamma(state.nets)
        weights = {k: v.detach().clone() for k, v in state.nets.state_dict().items()}
        gen = torch.Generator().manual_seed(SEED + 12)
        cres = small.model.resolution
        gp_noise = {d: {"alpha": torch.rand(TRAIN_BATCH, 1, 1, 1, generator=gen),
                        "noise": torch.rand(TRAIN_BATCH, cres, cres, 3, generator=gen) * 2 - 1}
                    for d in ("s", "t")}
        fp32_steps, bf16_bwd = {}, {}
        for row in compare_steps(small, weights, [_train_batch(rng, small, "cpu")
                                                  for _ in range(2)], gp_noise, phase="wide"):
            row["resolution"] = cres
            emit(row)
            rows.append(row)
            if not row["ok"]:
                fail("wide", f"512 channels: the card's {row['check']} disagrees beyond the "
                             "limits")
            for k, v in row["kernel_variants"].items():
                if "card float32" in row["check"]:
                    fp32_steps[k] = fp32_steps.get(k, 0) + v
                elif k.startswith((dq + "/", dkv + "/")):
                    bf16_bwd[k] = bf16_bwd.get(k, 0) + v
        # Every fp32 attention launch of the two steps on the 3xTF32 variant
        # (C 512: the wide kernel), each kernel at least once.
        tf32 = {f"{k}/{attention.TF32X3}" for k in (fwd, dq, dkv)}
        row = {"phase": "wide", "check": "512 channels: the fp32 G and D steps' launches",
               "launches_by_variant": fp32_steps, "resolution": cres,
               "ok": bool(set(fp32_steps) == tf32 and all(fp32_steps.values()))}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            fail("wide", "512 channels: the fp32 steps launched another variant than the "
                         "3xTF32 one, or missed a kernel")
        for k in (fwd, dq, dkv):
            launches[k] += fp32_steps[f"{k}/{attention.TF32X3}"]
        seconds["train_512_vs_cpu"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cfg = train_config(w512)
        trainer = TwinGANTrainer(cfg)  # the card, by default
        state = trainer.init_state(SEED)
        set_attention_gamma(state.nets)
        batches = [_train_batch(rng, cfg, "cuda") for _ in range(cfg.n_critic)]
        attention.reset_launch_counts()
        state, metrics = trainer.round_step(state, batches, rng=SEED)
        torch.cuda.synchronize()
        counts = {k: attention.launch_counts[k] for k in (fwd, dq, dkv, attention.PLAIN_ROUTE)}
        variants = {k: v for k, v in attention.variant_counts.items() if v}
        per_step = expected_launches(trainer, state.nets)
        expected = {k: per_step["g_step"][k] + (cfg.n_critic - 1) * per_step["d_step"][k]
                    for k in counts}
        # The attention's widths at 8 px (C 512, c_bar 64): B1 on its
        # tensor-core kernel, B2 and B3 on the cluster variant.
        _, _, _, c_bar512, c512 = WIDE_ATTENTION_CASES[0]
        expected_variants = {
            f"{k}/{expected_variant(k, torch.bfloat16, c_bar512, c512)}": expected[k]
            for k in (fwd, dq, dkv)}
        for k, v in variants.items():
            if k.startswith((dq + "/", dkv + "/")):
                bf16_bwd[k] = bf16_bwd.get(k, 0) + v
        losses = {k: float(v) for k, v in metrics.items()}
        row = {"phase": "wide", "check": "512 channels: one training round at 256 px",
               "batch": TRAIN_BATCH, "launches": counts, "expected_launches": expected,
               "kernel_variants": variants, "losses": losses,
               "round_s": time.perf_counter() - t0,
               "ok": bool(counts == expected and variants == expected_variants
                          and all(np.isfinite(v) for v in losses.values()))}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            fail("wide", "512 channels: the round's launches differ from the passes' count, "
                         "ran another variant than the bf16 one, or a loss is not finite")
        for k in (fwd, dq, dkv):
            launches[k] += counts[k]
        del trainer, state, batches
        seconds["round_512"] = time.perf_counter() - t0
        # Every bf16 B2 and B3 launch of the phase (the bf16 steps and the
        # round) on the cluster variant, each kernel at least once.
        cluster = {f"{k}/{attention.TENSOR_CORE_CLUSTER}" for k in (dq, dkv)}
        row = {"phase": "wide", "check": "512 channels: the bf16 B2 and B3 launches",
               "launches_by_variant": bf16_bwd,
               "ok": bool(set(bf16_bwd) == cluster and all(bf16_bwd.values()))}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            fail("wide", "512 channels: a bf16 B2 or B3 launch ran another variant than the "
                         "cluster one, or a kernel did not run")
        MEASURED["wide_bf16_backward_launches"] = bf16_bwd

        # 512 channels in int8: Q1's conv_i8q at 512 channels.
        t0 = time.perf_counter()
        stage_dir = served["stage_dir"]
        inferer = ImageInferer(stage_dir, quantize=True)
        x = torch.from_numpy(np.stack([inferer.preprocess(im) for im in images]))
        inferer.calibrate(x)
        m = inferer.model
        n_convs = len(list(quantized_convs(m.encoder_content, m.generator)))
        for counts in (attention, quant):
            counts.reset_launch_counts()
        with torch.no_grad():
            y = inferer.translate(x).float()
        torch.cuda.synchronize()
        b1, q1 = attention.launch_counts[fwd], quant.launch_counts[quant.FUSED_NAME]
        widest = max(conv.kernel.shape[0] for _, conv in quantized_convs(m.encoder_content,
                                                                          m.generator))
        # As the int8 phase holds it: fp32 inferers on the card and the CPU
        # at the served inferer's scales, each card conv given the CPU's input.
        a_max = {k: v.clone() for k, v in m.state_dict().items() if k.endswith("a_max")}
        x2 = x[:INT8_CPU_BATCH]
        infs = {}
        for dev in ("cuda", "cpu"):
            infs[dev] = ImageInferer(stage_dir, device=dev, dtype="float32", quantize=True)
            infs[dev].calibrate(x2)  # adds the buffers, switches to int8 ...
            infs[dev].model.load_state_dict(a_max, strict=False)  # ... at the card's scales
        trace, _ = int8_trace(infs["cpu"], x2, keep_io=True)
        mc = infs["cuda"].model
        card_convs = dict(quantized_convs(mc.encoder_content, mc.generator))
        forced = []
        with torch.no_grad():
            for name, _, (args, want) in trace:
                got = card_convs[name](*(a.cuda() if isinstance(a, torch.Tensor) else a
                                         for a in args))
                forced.append(bool(torch.equal(got.cpu(), want)))
        row = {"phase": "wide", "check": "512 channels: int8 serving, each conv given the "
                                         "CPU's input bit-equal",
               "b1_launches": b1, "q1_launches": q1, "quantized_convs": n_convs,
               "widest_conv_channels": widest, "layers_bit_equal": sum(forced),
               "layers": len(forced), "finite": bool(torch.isfinite(y).all()),
               "ok": bool(b1 == 2 and q1 == n_convs and widest == 512 and all(forced)
                          and len(forced) == n_convs and torch.isfinite(y).all())}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            fail("wide", "512 channels in int8: a conv differs from the CPU's given its input, "
                         "or Q1 did not run once a conv")
        launches[fwd] += b1
        launches[quant.FUSED_NAME] += q1
        del inferer, infs, trace, card_convs
        seconds["int8_512"] = time.perf_counter() - t0

        # 1024 channels, attention at 4 px: c_bar 128.
        t0 = time.perf_counter()
        served = _serve_vs_cpu("wide", w1024, root, "1024", {"bfloat16": 1}, 1, images)
        launches[fwd] += served["launches"]
        seconds["serve_1024"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # Cout 2048 past one block: a bf16 D step against the CPU (at 16 px:
    # the same 2048-channel layers, B4's two passes in its generator pass,
    # a quarter of the CPU's work), then at 32 px B4's launches in a D step
    # and a sample, and the sample against the CPU.
    t0 = time.perf_counter()
    small = w2048.replace(model=w2048.model.replace(resolution=WIDE_COMPARE_RESOLUTION))
    trainer = GanTrainer(small)  # the card, by default
    state = trainer.init_state(SEED)
    randomize_biases(state.nets, SEED)
    weights = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
    del trainer, state
    batches, zs, gp_noise = generation_inputs(small, WIDE_GEN_BATCH, SEED + 13)
    limits = {"bfloat16": (*TRAIN_LIMITS["bfloat16"][:3], None)}
    for row in compare_steps(small, weights, batches[1:], gp_noise, "cuda", GanTrainer, zs,
                             "wide", limits, {"d_step": "discriminator."},
                             b4_steps=("d_step",), kinds=("d_step",)):
        row["check"] = "Cout 2048: " + row["check"]
        row["resolution"] = small.model.resolution
        emit(row)
        rows.append(row)
        if not row["ok"]:
            fail("wide", f"the card's {row['check']} disagrees beyond the limits")
    del weights
    seconds["d_step_2048_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = GanTrainer(w2048)  # the card, by default
    state = trainer.init_state(SEED)
    randomize_biases(state.nets, SEED)
    batches, zs, gp_noise = generation_inputs(w2048, WIDE_GEN_BATCH, SEED + 13)
    batch = {"target": batches[1]["target"].cuda()}
    fused_conv.reset_launch_counts()
    state, _ = trainer.d_step(state, batch, z=zs["d_step"].cuda(), gp_noise=gp_noise)
    torch.cuda.synchronize()
    d_counts = dict(fused_conv.launch_counts)
    d_variants = {k: v for k, v in fused_conv.variant_counts.items() if v}
    d_routes = {k: v for k, v in fused_conv.route_counts.items() if v}
    z = torch.randn(noise_shape(w2048.model, WIDE_GEN_BATCH),
                    generator=torch.Generator().manual_seed(SEED + 14))
    fused_conv.reset_launch_counts()
    out = trainer.sample(state, z).float()
    torch.cuda.synchronize()
    s_counts = dict(fused_conv.launch_counts)
    s_variants = {k: v for k, v in fused_conv.variant_counts.items() if v}
    s_routes = {k: v for k, v in fused_conv.route_counts.items() if v}
    cpu = GanTrainer(w2048.replace(model=w2048.model.replace(dtype="float32")), device="cpu")
    nets = cpu.build_nets()
    nets.load_state_dict({k: v.cpu() for k, v in state.nets.state_dict().items()})
    ref = cpu.sample(cpu.state_from_nets(nets, step=state.step), z)
    out = out.cpu()
    std = float(ref.std())
    diff = (out - ref).abs()
    mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
    layers = WIDE_GEN_LAYERS_PER_PASS
    b4_tc = f"{fused_conv.KERNEL_NAME}/{fused_conv.VARIANTS[torch.bfloat16]}"
    widths = {p.shape[0] for n, p in state.nets.named_parameters()
              if n.startswith("generator.block_") and n.endswith("kernel")}
    row = {"phase": "wide", "check": "Cout 2048: B4 in a D step and a sample, the sample "
                                     "card bf16 vs CPU float32",
           "resolution": w2048.model.resolution, "batch": WIDE_GEN_BATCH,
           "generator_widths": sorted(widths), "d_step_launches": d_counts,
           "d_step_variants": d_variants, "d_step_routes": d_routes,
           "sample_launches": s_counts, "sample_variants": s_variants,
           "sample_routes": s_routes, "output_std": std, "mean_abs_err_over_std": mean_err,
           "max_abs_err_over_std": max_err, "mean_tolerance": SERVE_MEAN_TOL,
           "max_tolerance": SERVE_MAX_TOL, "seconds": time.perf_counter() - t0,
           "ok": bool(widths == {2048} and tuple(out.shape) == tuple(ref.shape)
                      and bool(torch.isfinite(out).all())
                      and d_counts == s_counts == {fused_conv.KERNEL_NAME: layers,
                                                   fused_conv.AUTOGRAD_ROUTE: 0}
                      and d_variants == s_variants == {b4_tc: layers}
                      and d_routes == s_routes == {fused_conv.ONE_PASS: layers}
                      and mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL)}
    emit(row)
    rows.append(row)
    if not row["ok"]:
        fail("wide", f"Cout 2048: B4 did not run {layers} times a generator pass on its "
                     "tensor-core variant in one pass, or the sample disagrees with the CPU")
    launches[fused_conv.KERNEL_NAME] += d_counts[fused_conv.KERNEL_NAME] + s_counts[
        fused_conv.KERNEL_NAME]
    seconds["b4_2048"] = time.perf_counter() - t0
    del trainer, state, cpu, nets
    torch.cuda.empty_cache()
    summary = {"phase": "wide", "check": "summary", "launches": launches,
               "seconds": time.perf_counter() - t_phase, "seconds_by_part": seconds,
               "card": card, "nvidia_smi": smi_line, "ok": all(r["ok"] for r in rows)}
    emit(summary)
    return launches


def conv_i8_entries(result: dict) -> list:
    """Q1's lines, one an entry: the sums over the convs of one int8
    translated batch of 4 (each distinct shape's row times its count), bf16
    out; ``conv_i8`` from int8 NHWC codes (the int8 entry, timed like for
    like with earlier versions of Q1), ``conv_i8q`` from each conv's own input type (what serving
    launches). library_ms: torch._int_mm on the unfolded input."""
    rows = [(r, n, dt) for r, (n, dt) in result["rows"] if n]
    library = [r["library_ms"] for r, _, _ in rows]
    library_ms = None if None in library else sum(r["library_ms"] * n for r, n, _ in rows)
    # Each entry's launches as its own counter read them on the serving path
    # and in the exported programs: serving and export go through conv_i8q
    # (its float-input instances); conv_i8's int8-input instances run only
    # where the kernel rows time them, so their count on the path is 0.
    launches = result["launches"]
    by_entry = {name: {"int8": launches[key],
                       "export": launches[f"export_bf16_{key}"] + launches[f"export_int8_{key}"],
                       "wide": launches.get(f"wide_{key}", 0)}
                for name, key in (("conv_i8", "q1_int8_in"), ("conv_i8q", "q1"))}
    entries = []
    for name, prefix in (("conv_i8", ""), ("conv_i8q", "q_")):
        def field(row, dtype, key):
            return row[prefix + key]["bfloat16" if not prefix else f"{dtype}->bfloat16"]

        def total(key):
            return sum(field(r, dt, key) * n for r, n, dt in rows)

        heaviest, _, dtype = max(rows, key=lambda rnd: field(rnd[0], rnd[2], "bound_ms") * rnd[1])
        entries.append(kernel_entry(
            name, sum(by_entry[name].values()), by_entry[name], 0.0, total("ms"),
            total("plain_ms"), total("bound_ms"), field(heaviest, dtype, "bound_by"), library_ms,
            variant=result["variant"],
            launches_by_entry={k: sum(v.values()) for k, v in by_entry.items()},
            times="per int8 translated batch of the slice config at batch 4, bf16 out: the "
                  "sum over its convs (device time); library_ms is torch._int_mm on the "
                  "unfolded input",
            convs_per_batch=sum(n for _, n, _ in rows),
            old_quantize_ms=sum(r["old_quantize_ms"] * n for r, n, _ in rows)))
    return entries


def kernel_entry(name: str, launches: int, by_path: dict, err: float, ms: float,
                 plain_ms: float, bound_ms: float, bound_by: str, library_ms: float,
                 **extra) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def kernel_variants(name: str) -> list:
    """The variants an attention kernel's entry point launches."""
    from twingan_tpu_torch.ops import attention

    return [k.split("/", 1)[1] for k in attention.variant_counts if k.startswith(name + "/")]


def fp32_entry(row: dict, name: str = "", grads=()) -> dict:
    """An attention kernel's fp32 numbers at the main shape (the kernel
    row ``row``; ``name`` and ``grads`` pick a backward kernel's): its
    variant, error, times, bound by its route and by both fp32 routes."""
    pick = (lambda v: v[name]) if name else (lambda v: v)  # noqa: E731
    err = max(row["max_abs_err"][g] for g in grads) if name else row["max_abs_err"]
    return {"variant": pick(row["variant"])[0], "max_abs_err": err, "ms": pick(row["ms"]),
            "device_ms": pick(row["device_ms"]), "plain_ms": pick(row["plain_ms"]),
            "library_ms": row["library_ms"], "bound_ms": pick(row["bound_ms"]),
            "bound_by": pick(row["bound_by"]),
            "bound_ms_by_route": {r: pick(v) for r, v in row["bound_ms_by_route"].items()},
            "shape": {k: row[k] for k in ("B", "N", "c_bar", "C")}}


def fused_conv_entry(rows_by_type: dict, launches: dict, more: dict) -> dict:
    """B4's line: the sums over the 13 layers of one pggan256 generator
    pass at batch 12 (each distinct layer's row times its count), bf16, and
    the same for fp32 under ``fp32`` (with its bound by both fp32 routes);
    ``more`` holds the launches of the paths after the generation phase."""
    from twingan_tpu_torch.ops import fused_conv

    def total(key, rows):
        return sum(r[key] * r["layers_per_pass"] for r in rows)

    f32 = rows_by_type["float32"]
    fp32 = {"variant": f32[0]["variant"][0],
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            **{k: total(k, f32) for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                          "library_best_ms", "bound_ms")},
            "bound_ms_by_route": {r: sum(row["bound_ms_by_route"][r] * row["layers_per_pass"]
                                         for row in f32) for r in FP32_ROUTES},
            "layers": [{k: r[k] for k in ("case", "H", "Cin", "Cout", "layers_per_pass",
                                          "device_ms", "library_ms", "bound_ms")} for r in f32]}
    layer_rows = rows_by_type["bfloat16"]

    def total_bf16(key):
        return total(key, layer_rows)

    heaviest = max(layer_rows, key=lambda r: r["bound_ms"] * r["layers_per_pass"])
    by_path = {"generation": sum(launches.values()), **more}
    return kernel_entry(
        "fused_conv", sum(by_path.values()), by_path,
        max(r["max_abs_err"] for r in layer_rows), total_bf16("ms"), total_bf16("plain_ms"),
        total_bf16("bound_ms"), heaviest["bound_by"], total_bf16("library_ms"),
        launches_in_generation=launches, variant=heaviest["variant"][0],
        variants=sorted(set(fused_conv.VARIANTS.values())),
        times="per generator pass of pggan256 at batch 12: the sum over its 13 "
              "conv-leaky-pixel-norm layers; library_ms is cuDNN's conv alone (NCHW), "
              "library_best_ms the same at its best (benchmark mode, channels-last)",
        library_best_ms=total_bf16("library_best_ms"),
        eager_chain_ms=total_bf16("eager_chain_ms"), device_ms=total_bf16("device_ms"),
        fp32=fp32, routes=sorted(fused_conv.route_counts), wide=MEASURED.get("fused_conv_wide"))


def require_no_b4(phase: str) -> None:
    """The serving and training configurations (batch norm) have no
    conv-leaky-pixel-norm layer: B4 must not have run."""
    from twingan_tpu_torch.ops import fused_conv

    if any(fused_conv.launch_counts.values()):
        fail(phase, f"B4 routes taken on the {phase} path: {fused_conv.launch_counts}")


def main() -> int:
    start_watchdog()
    card, smi_line = device_phase()
    import torch
    from twingan_tpu_torch.ops import attention, fused_conv

    build_phase()
    serving_rows = kernel_phase()
    train_rows = backward_kernel_phase()
    b4_rows = fused_conv_phase()
    fused_conv.reset_launch_counts()
    serving_launches = serving_phase(card, smi_line)
    require_no_b4("serving")
    http_launches = http_phase(card, smi_line)
    require_no_b4("http")
    train_launches = train_phase(card, smi_line)
    require_no_b4("train")
    fp32_launches = fp32_phase(card, smi_line)
    generation_launches = generation_phase(card, smi_line)
    runner_launches = runner_phase(card, smi_line)
    root = tempfile.mkdtemp(prefix="twingan_smoke_data_")
    try:
        data = data_phase(card, smi_line, root)
        data["root"] = root
        realdata = runner_data_phase(card, smi_line, data)
        eval_launches = eval_phase(card, smi_line, data, realdata["twingan_dir"])
        recipe_launches = recipe_phase(card, smi_line)
        options_launches = options_phase(card, smi_line)
        classifier_launches = classifiers_phase(card, smi_line, data, realdata["twingan_dir"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    int8 = int8_phase(card, smi_line)
    parallel_launches = parallel_phase(card, smi_line)
    alt_launches = alt_gans_phase(card, smi_line)
    wide_launches = wide_phase(card, smi_line)
    int8["launches"]["wide_q1"] = wide_launches["conv_i8q"]
    data_launches = realdata["launches"]
    fwd = "flash_attn_fwd"
    by_path = {"serving": serving_launches, "http": http_launches,
               "train": train_launches[fwd], "fp32": fp32_launches[fwd],
               "runner": runner_launches[fwd], "runner_data": data_launches[fwd],
               "eval": eval_launches[fwd], "recipe": recipe_launches[fwd],
               "options": options_launches[fwd], "classifiers": classifier_launches,
               "int8": int8["launches"]["b1"],
               "export": int8["launches"]["export_bf16_b1"] + int8["launches"]["export_int8_b1"],
               "parallel": parallel_launches[fwd], "alt_gans_import": alt_launches[fwd],
               "wide": wide_launches[fwd]}
    row = serving_rows["bfloat16"]
    entries = [kernel_entry(
        fwd, sum(by_path.values()), by_path, row["max_abs_err"], row["ms"], row["plain_ms"],
        row["bound_ms"], row["bound_by"], row["library_ms"], variant=row["variant"][0],
        variants=kernel_variants(fwd), device_ms=row["device_ms"],
        fp32=fp32_entry(serving_rows["float32"]), wide=MEASURED.get(f"{fwd}_wide"))]
    for name, grads in (("flash_attn_dq", ("df",)), ("flash_attn_dkv", ("dg", "dh"))):
        by_path = {"train": train_launches[name], "fp32": fp32_launches[name],
                   "runner": runner_launches[name],
                   "runner_data": data_launches[name], "eval": eval_launches[name],
                   "recipe": recipe_launches[name], "options": options_launches[name],
                   "parallel": parallel_launches[name], "wide": wide_launches[name]}
        row = train_rows["bfloat16"]
        entries.append(kernel_entry(
            name, sum(by_path.values()), by_path,
            max(row["max_abs_err"][g] for g in grads), row["ms"][name], row["plain_ms"][name],
            row["bound_ms"][name], row["bound_by"][name], row["library_ms"],
            variant=row["variant"][name][0], variants=kernel_variants(name),
            device_ms=row["device_ms"][name], fp32=fp32_entry(train_rows["float32"], name, grads),
            wide=MEASURED.get(f"{name}_wide"),
            wide_bf16_variant=attention.WIDE_VARIANTS[name][torch.bfloat16],
            wide_bf16_launches={k: v for k, v in MEASURED["wide_bf16_backward_launches"].items()
                                if k.startswith(name + "/")}))
    entries.append(fused_conv_entry(b4_rows, generation_launches,
                                    {"fp32": fp32_launches["fused_conv"],
                                     "runner": runner_launches["fused_conv"],
                                     "runner_data": data_launches["fused_conv"],
                                     "recipe": recipe_launches["fused_conv"],
                                     "options": options_launches["fused_conv"],
                                     "parallel": parallel_launches["fused_conv"],
                                     "wide": wide_launches["fused_conv"]}))
    entries.extend(conv_i8_entries(int8))
    emit({"kernels": entries})
    print(smi_line, flush=True)

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
