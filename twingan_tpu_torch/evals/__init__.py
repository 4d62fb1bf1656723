"""Evaluation: the SWD protocol, MS-SSIM, FID and the inception score,
streaming loss means, eval-debug galleries, and the ``run_eval`` CLI."""
