"""A TwinGAN stage of the port's runner on real data: two domains of
shards written by the JAX converter, combined by ``UnpairedSource``, feed
the augmentation the same raw batches as the JAX runner's, and the
in-training SWD translates the stage's fixed batch at every step. A file
of its own so that its JAX compiles land on another test worker than
``test_torch_runner_realdata.py``'s.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

from test_torch_runner_realdata import (  # noqa: E402
    _two_torch_threads,  # noqa: F401
    jax_run,
    port_run,
    same_batches,
    shards,  # noqa: F401
    swd_layout,
)


def test_unpaired_twingan_stage_feeds_the_jax_batches(shards, monkeypatch):  # noqa: F811
    theirs = jax_run(shards, monkeypatch, "twingan", "jax_twin", 16, 16)
    ours, summary = port_run(shards, monkeypatch, "twingan", "port_twin", 16, 16)
    assert summary["16"]["steps"] == 2
    assert len(ours) == 8  # 2 rounds x n_critic 2 x (source, target)
    same_batches(ours, theirs)
    names = sorted(n for n in os.listdir(shards / "port_twin" / "16") if n.startswith("swd"))
    assert names == ["swd_in_training_1.txt", "swd_in_training_2.txt"]
    for name in names:
        assert swd_layout(shards / "port_twin" / "16" / name) == swd_layout(
            shards / "jax_twin" / "16" / name)


def test_unpaired_stage_streams_the_same_batches(shards, monkeypatch):  # noqa: F811
    resident, _ = port_run(shards, monkeypatch, "twingan", "twin_res", 16, 16)
    streaming, _ = port_run(shards, monkeypatch, "twingan", "twin_stream", 16, 16,
                            device_resident_gb=0)
    same_batches(streaming, resident)
