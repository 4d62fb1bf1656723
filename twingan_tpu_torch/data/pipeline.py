"""Input pipeline: record sources -> host decode/resize -> batches on the
device, from a background prefetcher or from a dataset held on the device.

Counterpart of ``twingan_tpu/data/pipeline.py``, the same classes with the
same sample sequences:

- ``SyntheticSource``: the same arrays as the JAX one for the same seed,
  keys and ``num_classes`` (numpy's ``RandomState`` draws, in order);
- ``TFRecordSource``: shuffled epochs from ``np.random.RandomState(seed)``
  over tfrecord shards, host decode (``data/datasets.py``) and resize
  (``data/preprocess.py``, PIL-free), the decoded-sample cache and its byte
  cap, the contiguous arrays built once every sample is cached, and
  ``materialize`` for the device-resident path;
- ``UnpairedSource``: two datasets as {source, target} with a_/b_ extras;
- ``DeviceResidentSampler``: each key's array placed on the device once,
  the JAX ``_indices`` epoch permutations, and batches gathered with
  ``index_select`` on the device, so a round moves only its indices;
- ``DevicePrefetcher``: a background thread that copies batches into
  pinned host memory and on to the device with ``non_blocking`` copies on
  a side stream, with an event the consumer's stream waits on.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from twingan_tpu_torch.data.datasets import DatasetSpec
from twingan_tpu_torch.data.preprocess import PreprocessConfig, host_resize_uint8
from twingan_tpu_torch.data.tfrecord import TFRecordReader

_IMAGE_KEYS = ("source", "target", "image")


class SyntheticSource:
    """Uniform-random float32 image batches in [0, 1) under each of
    ``keys``, and one-hot ``conditional_labels`` of ``num_classes``."""

    def __init__(self, batch_size: int, hw: int, channels: int = 3, seed: int = 0,
                 keys: Sequence[str] = ("source", "target"), num_classes: int = 0):
        self.batch_size, self.hw, self.channels = batch_size, hw, channels
        self.keys = tuple(keys)
        self.num_classes = num_classes
        self._rng = np.random.RandomState(seed)

    def _item(self, key: str) -> np.ndarray:
        if key == "conditional_labels":
            ids = self._rng.randint(0, max(self.num_classes, 1), self.batch_size)
            hot = np.zeros((self.batch_size, max(self.num_classes, 1)), np.float32)
            hot[np.arange(self.batch_size), ids] = 1.0
            return hot
        return self._rng.rand(self.batch_size, self.hw, self.hw,
                              self.channels).astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield {k: self._item(k) for k in self.keys}


class TFRecordSource:
    """Shuffled epoch iterator over tfrecord shards with host-side
    decode + resize to the fixed pre-augmentation hw."""

    def __init__(
        self,
        spec: DatasetSpec,
        shard_paths: Sequence[str],
        preprocess: PreprocessConfig,
        batch_size: int,
        seed: int = 0,
        repeat: bool = True,
        drop_remainder: bool = True,
        cache: bool = True,
        cache_max_bytes: int = 4 << 30,
        yield_uint8: bool = False,
    ):
        if not shard_paths:
            raise ValueError(f"no tfrecord shards given for dataset {spec.name}")
        self.spec = spec
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.repeat = repeat
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)
        # Images are cached AND yielded as uint8 when yield_uint8=True: 4x
        # more samples fit in cache_max_bytes, and the host->device copy
        # moves 1 byte/px; augment_batch converts to [0,1] float on the
        # device. Default False keeps the float [0,1] contract for
        # eval/metric consumers.
        self.yield_uint8 = yield_uint8
        self.readers = [TFRecordReader(p) for p in shard_paths]
        self.index = [(si, ri) for si, r in enumerate(self.readers) for ri in range(len(r))]
        if not self.index:
            raise ValueError(f"tfrecord shards for {spec.name} are empty")
        if repeat and drop_remainder and len(self.index) < batch_size:
            # Every epoch would drop its only (short) batch: an infinite
            # iterator that never yields. Fail loudly instead.
            raise ValueError(
                f"dataset {spec.name} has {len(self.index)} records but "
                f"batch_size={batch_size} with drop_remainder — no batch "
                "can ever be produced")
        # Decoded-sample cache: after one epoch, decode/resize never runs
        # again (the augmentation stays random because it runs on device).
        self._cache: dict = {} if cache else None
        self._cache_bytes = 0
        self._cache_max_bytes = cache_max_bytes
        # Contiguous-array cache: once every sample is decoded, batches are
        # assembled by one vectorized fancy-index per key instead of
        # per-sample dict/stack work.
        self._arrays: Optional[Dict[str, np.ndarray]] = None
        self._arrays_failed = False  # memoized: ragged items, keep dicts

    @property
    def num_samples(self) -> int:
        return len(self.index)

    def _sample(self, si: int, ri: int) -> Dict[str, np.ndarray]:
        random_resize = self.preprocess.resize_mode.startswith("RANDOM")
        if self._cache is not None and not random_resize:
            cached = self._cache.get((si, ri))
            if cached is not None:
                return cached
        item = self.spec.parse(self.readers[si][ri])
        pp = self.preprocess
        for key in _IMAGE_KEYS:
            img = item.get(key)
            if img is not None and getattr(img, "ndim", 0) >= 2:
                item[key] = host_resize_uint8(
                    img, pp.resize_mode, pp.host_hw, rng=self._rng,
                    initial_crop_hw=pp.initial_crop_hw,
                )
        if self._cache is not None and not random_resize and (
            self._cache_bytes < self._cache_max_bytes
        ):
            self._cache[(si, ri)] = item
            self._cache_bytes += sum(
                getattr(v, "nbytes", 0) for v in item.values()
            )
        return item

    def _maybe_build_arrays(self) -> None:
        """Promote a complete dict cache to contiguous per-key arrays."""
        if (
            self._arrays is not None
            or self._arrays_failed
            or self._cache is None
            or len(self._cache) != len(self.index)
        ):
            return
        samples = [self._cache[(si, ri)] for si, ri in self.index]
        keys = set(samples[0])
        for s in samples[1:]:
            keys &= set(s)
        arrays = {}
        for k in keys:
            vals = [s[k] for s in samples]
            first = vals[0]
            if getattr(first, "dtype", None) is not None and first.dtype.kind in "SU":
                arrays[k] = np.asarray(vals)
            elif all(np.shape(v) == np.shape(first) for v in vals):
                arrays[k] = np.stack(vals)
            else:
                # Ragged item (e.g. variable tag lists): keep dicts, and
                # don't redo this O(dataset) attempt every epoch.
                self._arrays_failed = True
                return
        self._arrays = arrays
        self._cache = {}  # free the duplicate dict storage
        self._cache_bytes = 0

    def materialize(self, max_bytes: int = 0) -> Optional[Dict[str, np.ndarray]]:
        """Force-decode every record into the contiguous per-key arrays and
        return them ({key: [N, ...]}), or None when the dataset cannot be
        materialized: random host resize (content must differ per epoch),
        ragged items, any undecodable record (the streaming path skips
        those; a resident array cannot), or total bytes over ``max_bytes``.

        Host half of the device-resident data path (DeviceResidentSampler):
        the arrays are copied to the device once and batches become
        on-device gathers, so a round moves only its indices."""
        if self.preprocess.resize_mode.startswith("RANDOM"):
            return None
        if self._arrays is None and not self._arrays_failed:
            if self._cache is None:
                self._cache = {}
            self._cache_max_bytes = max(
                self._cache_max_bytes, max_bytes or (64 << 30)
            )
            try:
                for si, ri in self.index:
                    if (si, ri) not in self._cache:
                        self._sample(si, ri)
                    if self._cache_bytes >= self._cache_max_bytes:
                        return None  # over budget: bail before decoding all
            except Exception:
                return None
            if len(self._cache) != len(self.index):
                return None  # cache budget hit mid-decode
            self._maybe_build_arrays()
        if self._arrays is None:
            return None
        if max_bytes and sum(v.nbytes for v in self._arrays.values()) > max_bytes:
            return None
        return self._arrays

    def _finalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """uint8 image items -> float32 [0,1] unless yield_uint8."""
        if self.yield_uint8:
            return batch
        for k in _IMAGE_KEYS:
            v = batch.get(k)
            if v is not None and getattr(v, "dtype", None) == np.uint8:
                batch[k] = v.astype(np.float32) / 255.0
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            self._maybe_build_arrays()
            if self._arrays is not None:
                n = len(self.index)
                order = self._rng.permutation(n)
                stop = n - self.batch_size + 1 if self.drop_remainder else n
                for i in range(0, stop, self.batch_size):
                    idx = order[i : i + self.batch_size]
                    yield self._finalize({k: v[idx] for k, v in self._arrays.items()})
                if not self.repeat:
                    return
                continue
            order = self._rng.permutation(len(self.index))
            batch: list = []
            failures = 0
            for idx in order:
                si, ri = self.index[idx]
                try:
                    batch.append(self._sample(si, ri))
                    failures = 0
                except Exception as e:
                    # Skip undecodable records like the ref converters — but
                    # a spec that fails on EVERY record (wrong dataset/spec
                    # pairing) must error, not spin an empty infinite epoch.
                    failures += 1
                    if failures >= len(self.index):
                        raise RuntimeError(
                            f"every record failed to parse/decode (last: {e!r}) "
                            "— wrong --dataset_name for these shards?"
                        ) from e
                    continue
                if len(batch) == self.batch_size:
                    yield self._finalize(_collate(batch))
                    batch = []
            if batch and not self.drop_remainder:
                yield self._finalize(_collate(batch))
            if not self.repeat:
                return


def _collate(samples: list) -> Dict[str, np.ndarray]:
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    out = {}
    for k in keys:
        vals = [s[k] for s in samples]
        if getattr(vals[0], "dtype", None) is not None and vals[0].dtype.kind in "SU":
            out[k] = np.asarray(vals)
        else:
            out[k] = np.stack(vals)
    return out


class UnpairedSource:
    """Combines two datasets into {source, target} batches with a_/b_ extras
    (reference _combine_unpaired_data, model_inheritor.py:845-856)."""

    def __init__(self, source_iter, target_iter):
        self.source_iter = source_iter
        self.target_iter = target_iter

    def __iter__(self):
        for a, b in zip(iter(self.source_iter), iter(self.target_iter)):
            batch = {}
            for k, v in a.items():
                batch[f"a_{k}"] = v
            for k, v in b.items():
                batch[f"b_{k}"] = v
            batch["source"] = a.get("source", a.get("target"))
            batch["target"] = b.get("source", b.get("target"))
            if "embedding" in a:
                batch["source_embedding"] = a["embedding"]
            if "embedding" in b:
                batch["target_embedding"] = b["embedding"]
            yield batch


class DeviceResidentSampler:
    """The dataset on the device: each domain's per-key arrays are copied
    to ``device`` once, and shuffled-epoch batches are gathered there with
    ``index_select``, so a round moves only its sample indices.

    ``domains`` is a list of (arrays, key_map, seed): ``arrays`` a
    materialized {in_key: [N, ...]} dict (``TFRecordSource.materialize``),
    ``key_map`` {out_key: in_key} naming what this domain contributes to
    the batch (e.g. {"source": "source", "source_embedding": "embedding"}).
    Each domain's indices replicate ``TFRecordSource.__iter__`` over built
    arrays exactly (``np.random.RandomState(seed).permutation(N)`` an epoch,
    consumed batch_size at a time, the short tail dropped), so a resident
    run sees the same sample sequence as a streaming run.
    """

    def __init__(self, domains, batch_size: int, device: torch.device | str):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.resident_bytes = 0
        self.last_index_bytes = 0
        self._domains = []
        for arrays, key_map, seed in domains:
            n = None
            dev = {}
            for out_key, in_key in key_map.items():
                if in_key not in arrays:
                    continue
                arr = arrays[in_key]
                n = len(arr) if n is None else n
                if len(arr) != n:
                    raise ValueError(
                        f"domain arrays disagree on N: {in_key} has "
                        f"{len(arr)}, expected {n}")
                arr = np.ascontiguousarray(arr)
                dev[out_key] = torch.from_numpy(arr).to(self.device)
                self.resident_bytes += arr.nbytes
            if not dev:
                continue
            if n < batch_size:
                raise ValueError(
                    f"device-resident domain has {n} samples < batch_size "
                    f"{batch_size} with drop_remainder — no batch possible")
            self._domains.append(
                {"n": n, "dev": dev, "rng": np.random.RandomState(seed),
                 "pos": n, "order": None}  # pos=n forces a fresh epoch
            )
        if not self._domains:
            raise ValueError("DeviceResidentSampler: no usable domains")

    def _indices(self, dom, count: int) -> np.ndarray:
        """``count`` consecutive batches of indices from this domain's
        shuffled-epoch stream -> [count, batch_size] int32."""
        out = np.empty((count, self.batch_size), np.int32)
        for c in range(count):
            if dom["pos"] + self.batch_size > dom["n"]:
                dom["order"] = dom["rng"].permutation(dom["n"])
                dom["pos"] = 0
            out[c] = dom["order"][dom["pos"]: dom["pos"] + self.batch_size]
            dom["pos"] += self.batch_size
        return out

    def sample_chunk(self, n_rounds: int, n_critic: int = 1) -> Dict[str, torch.Tensor]:
        """{out_key: [n_rounds, n_critic, B, ...] device tensor}: raw
        (pre-augmentation) samples, gathered on the device."""
        self.last_index_bytes = 0
        out = {}
        for dom in self._domains:
            idx = self._indices(dom, n_rounds * n_critic)
            self.last_index_bytes += idx.nbytes
            flat = torch.from_numpy(idx.reshape(-1)).to(self.device, non_blocking=True)
            for out_key, d in dom["dev"].items():
                out[out_key] = d.index_select(0, flat).reshape(
                    (n_rounds, n_critic, self.batch_size) + d.shape[1:])
        return out

    def sample_batches(self, n_critic: int = 1):
        """n_critic single batches ([B, ...] device tensors)."""
        chunk = self.sample_chunk(1, n_critic)
        return [{k: v[0, c] for k, v in chunk.items()} for c in range(n_critic)]


class DevicePrefetcher:
    """A background thread that keeps ``depth`` batches ready on ``device``.

    Each batch's arrays are copied into pinned host memory and on to the
    card with ``non_blocking`` copies on a side stream; an event recorded
    after them is waited on by the consumer's current stream in
    ``__next__``, and each tensor is recorded on that stream for the
    caching allocator. On the CPU the batch becomes tensors sharing the
    arrays' memory. With ``to_device=False`` it yields the host arrays (the
    caller stacks many batches into one copy). String items are dropped;
    ``keys`` keeps only those items."""

    def __init__(self, source, depth: int = 2, device: torch.device | str = "cpu",
                 keys: Optional[Sequence[str]] = None, to_device: bool = True):
        self.source = source
        self.depth = depth
        self.device = torch.device(device)
        self.keys = tuple(keys) if keys else None
        self.to_device = to_device
        self._stream = (torch.cuda.Stream(self.device)
                        if to_device and self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict[str, np.ndarray]):
        """(batch, event): host arrays, CPU tensors, or device tensors whose
        copies the event follows."""
        if not self.to_device:
            return batch, None
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return {k: t.to(self.device) for k, t in tensors.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, batch):
        if self.keys:
            batch = {k: batch[k] for k in self.keys if k in batch}
        else:
            batch = {k: v for k, v in batch.items() if getattr(v, "dtype", None) is not None
                     and v.dtype.kind not in "SU"}
        item = self._stage(batch)
        # Bounded put that stays responsive to close(): a daemon thread
        # blocked in Queue.put during interpreter teardown aborts the process.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            for batch in iter(self.source):
                if self._stop.is_set():
                    return
                self._put(batch)
        except BaseException as e:  # surface in __next__, not as a clean end
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._error is not None:
                # A worker crash must not look like the end of the data: an
                # endless training source "ending" would cut a run short.
                raise RuntimeError("DevicePrefetcher worker failed") from self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
