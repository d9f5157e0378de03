"""Webdataset-style tar-shard video pipeline with per-rank sharding.

Port of t2v_turbo_tpu/data/webdata.py, a rebuild of the reference's WebVid
loader (data/dataset.py:42-151 + data/dataloader/custom_wds.py): tar shards
-> a per-rank split (a mesh's data index and data size, so the seq ranks of
one data index read the same clips; without a mesh the rank and world size
of `torch.distributed` when it is initialised, else 0 and 1;
wds.split_by_node in the reference) -> shard
shuffle -> samples grouped by key -> mp4 decode by the native video library
-> resize / crop -> dict batches. A sample whose mp4 does not decode is
skipped (the reference's warn-and-continue, data/dataset.py:58); a dataset
whose decoder cannot load raises when it is constructed, since a loop that
skips every sample would never yield.

Pure Python plus the native decoder; no webdataset or torchdata.
"""

from __future__ import annotations

import json
import math
import pickle
import random
import tarfile
import tempfile
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from . import videoio
from .transforms import KeyFilter, normalize_video, resize_crop


def split_shards_by_host(
    shards: Sequence[str],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    mesh=None,
) -> List[str]:
    """Deterministic per-rank shard assignment (reference
    data/dataset.py:101-105 split_by_node): over a `mesh` (parallel/mesh.py)
    by its data index and data size, so every seq rank of a data index gets
    the same shards."""
    if mesh is not None:
        process_index, process_count = mesh.coords()[0], mesh.data
    if process_index is None:
        import torch.distributed as dist

        initialised = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if initialised else 0
        process_count = dist.get_world_size() if initialised else 1
    return list(shards)[process_index::process_count]


def iterate_tar_samples(path: str) -> Iterator[dict]:
    """Group tar members by basename key: {key, mp4: bytes, txt: str, json: dict}."""
    with tarfile.open(path, "r|*") as tf:
        current_key = None
        sample = {}
        for member in tf:
            if not member.isfile():
                continue
            key, _, ext = member.name.rpartition(".")
            if not key:
                continue
            if current_key is not None and key != current_key and sample:
                yield {"key": current_key, **sample}
                sample = {}
            current_key = key
            data = tf.extractfile(member).read()
            if ext in ("txt", "text", "caption"):
                sample["txt"] = data.decode("utf-8", "replace").strip()
            elif ext == "json":
                try:
                    sample["json"] = json.loads(data)
                except ValueError:
                    sample["json"] = {}
            elif ext in ("mp4", "webm", "mov", "avi", "mkv"):
                sample["mp4"] = data
        if current_key is not None and sample:
            yield {"key": current_key, **sample}


def decode_sample_video(
    data: bytes,
    n_frames: int,
    target_fps: float,
    size_hw,
    random_crop: bool,
    rng: np.random.RandomState,
) -> Optional[np.ndarray]:
    """mp4 bytes -> (T, H, W, 3) uint8, or None when the bytes do not decode
    or the video is smaller than the crop (warn-and-continue)."""
    seed = int(rng.randint(0, 2**31 - 1))
    try:
        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(data)
            f.flush()
            video = videoio.decode(f.name, n_frames=n_frames, target_fps=target_fps,
                                   random_offset=random_crop, seed=seed)
        return resize_crop(video, size_hw, random_crop=random_crop, rng=rng)
    except (IOError, ValueError):
        return None


def resample_shards_by_prefix(shards: Sequence[str], weights: dict, seed: int = 0) -> Iterator[str]:
    """Mixture-of-prefixes shard stream (reference
    data/dataloader/custom_wds.py:312-393 PrefixResampler): each draw picks
    a prefix with probability proportional to its weight, then a shard
    uniformly without replacement from that prefix's pool, refilling a pool
    only when it empties. Each shard belongs to its first matching prefix in
    `weights` order (reference custom_wds.py:335); a shard that matches no
    prefix is an error. Prefixes without shards are dropped and the other
    weights renormalised. An infinite iterator; the arguments are checked
    when it is made, not at its first draw."""
    pools: dict = {p: [] for p in weights}
    unmatched = []
    for s in shards:
        for p in weights:
            if s.startswith(p):
                pools[p].append(s)
                break
        else:
            unmatched.append(s)
    if unmatched:
        raise ValueError(
            f"{len(unmatched)} shard(s) match no prefix in {list(weights)} (first: {unmatched[0]}); every shard "
            "must belong to a mixture component")
    pools = {p: v for p, v in pools.items() if v}
    if not pools:
        raise ValueError(f"no shard matches any prefix {list(weights)} (have {len(shards)} shards)")
    names = list(pools)
    ps = np.asarray([float(weights[p]) for p in names])
    ps = ps / ps.sum()

    def draw() -> Iterator[str]:
        rng = np.random.RandomState(seed)
        avail = {p: list(v) for p, v in pools.items()}
        while True:
            p = names[rng.choice(len(names), p=ps)]
            if not avail[p]:
                avail[p] = list(pools[p])
            yield avail[p].pop(rng.randint(len(avail[p])))

    return draw()


class LatentWebDataset:
    """Tar shards of pickled latent dicts -> fixed-size batches; the
    reference's Text2VideoDataset (data/video_webdata.py:87-147), the
    webdataset twin of datasets.MP4LatentDataset.

    Shards are resampled with replacement (an infinite stream, not epochs),
    samples pass a shuffle buffer, batches are full-size only, and
    num_batches / num_samples derive from num_train_examples as the
    reference's :122-124. Each .pickle / .pkl member holds one sample;
    fields are defaulted as datasets.MP4LatentDataset's, so a trainer sees
    one schema from either loader. The pickles must come from this
    program's own preprocessing: unpickling runs code.
    """

    PICKLE_EXTS = ("pickle", "pkl")

    def __init__(
        self,
        shards: Sequence[str],
        num_train_examples: int,
        per_host_batch_size: int,
        global_batch_size: int,
        shuffle_buffer_size: int = 1000,
        seed: int = 0,
        split_by_host: bool = True,
        mesh=None,
    ):
        self.shards = list(shards)
        if split_by_host:
            self.shards = split_shards_by_host(self.shards, mesh=mesh)
        if not self.shards:
            raise ValueError("no shards for this host")
        self.per_host_batch_size = per_host_batch_size
        self.shuffle_buffer_size = shuffle_buffer_size
        self.seed = seed
        self.num_batches = math.ceil(num_train_examples / global_batch_size)
        self.num_samples = self.num_batches * global_batch_size
        self.batch_size = global_batch_size

    def _samples(self) -> Iterator[dict]:
        from .datasets import MP4LatentDataset, apply_latent_defaults

        rng = random.Random(self.seed)
        buf: List[dict] = []
        while True:  # resampled shards: infinite, with replacement
            shard = self.shards[rng.randrange(len(self.shards))]
            try:
                with tarfile.open(shard, "r|*") as tf:
                    for member in tf:
                        ext = member.name.rpartition(".")[2]
                        if not member.isfile() or ext not in self.PICKLE_EXTS:
                            continue
                        try:
                            d = pickle.loads(tf.extractfile(member).read())
                        except Exception:  # a corrupt pickle raises anything: skip it, as wds does
                            continue
                        if not isinstance(d, dict) or any(k not in d for k in MP4LatentDataset.REQUIRED):
                            continue
                        apply_latent_defaults(d)
                        if self.shuffle_buffer_size > 1:
                            buf.append(d)
                            if len(buf) >= self.shuffle_buffer_size:
                                yield buf.pop(rng.randrange(len(buf)))
                        else:
                            yield d
            except (OSError, EOFError, tarfile.TarError):
                continue  # unreadable shard: warn-and-continue

    def __iter__(self) -> Iterator[dict]:
        from .datasets import collate_latent_batch

        batch: List[dict] = []
        for d in self._samples():
            batch.append(d)
            if len(batch) == self.per_host_batch_size:
                yield collate_latent_batch(batch)
                batch = []


class WebVideoDataset:
    """Iterable: tar shards -> batches
    {video: (B,T,H,W,3) float32 [-1,1], txt: [str], json: [dict]}.
    Loads the native decoder when constructed (raises if it cannot)."""

    def __init__(
        self,
        shards: Sequence[str],
        batch_size: int = 1,
        n_frames: int = 16,
        target_fps: float = 8.0,
        size_hw=(320, 512),
        random_crop: bool = True,
        shuffle_shards: bool = True,
        shuffle_buffer: int = 0,
        filters: Optional[Sequence[Callable[[dict], bool]]] = None,
        seed: int = 0,
        split_by_host: bool = True,
        loop: bool = True,
        normalize: bool = True,
        prefix_weights: Optional[dict] = None,
        mesh=None,
    ):
        videoio.load()
        self.shards = list(shards)
        if split_by_host:
            self.shards = split_shards_by_host(self.shards, mesh=mesh)
        if not self.shards:
            raise ValueError("WebVideoDataset: no shards")
        self.batch_size = batch_size
        self.n_frames = n_frames
        self.target_fps = target_fps
        self.size_hw = tuple(size_hw)
        self.random_crop = random_crop
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = shuffle_buffer
        self.filters = list(filters or [KeyFilter()])
        self.seed = seed
        self.loop = loop
        self.normalize = normalize
        self.prefix_weights = prefix_weights
        if prefix_weights:  # check the mixture now, not at the first batch
            resample_shards_by_prefix(self.shards, prefix_weights, seed=seed)

    def _shard_stream(self, rng, epoch: int):
        """One epoch's shard paths: a plain shuffle, or the mixture-of-
        prefixes resampler when prefix_weights is set."""
        if self.prefix_weights:
            it = resample_shards_by_prefix(self.shards, self.prefix_weights, seed=self.seed + epoch)
            return [next(it) for _ in range(len(self.shards))]
        shards = list(self.shards)
        if self.shuffle_shards:
            rng.shuffle(shards)
        return shards

    def _samples(self) -> Iterator[dict]:
        rng = random.Random(self.seed)
        epoch = 0
        while True:
            buf: List[dict] = []
            for shard in self._shard_stream(rng, epoch):
                try:
                    for s in iterate_tar_samples(shard):
                        if not all(f(s) for f in self.filters):
                            continue
                        if self.shuffle_buffer > 1:
                            buf.append(s)
                            if len(buf) >= self.shuffle_buffer:
                                yield buf.pop(rng.randrange(len(buf)))
                        else:
                            yield s
                except (OSError, EOFError, tarfile.TarError):
                    continue  # unreadable shard: warn-and-continue
            yield from buf
            epoch += 1
            if not self.loop:
                return

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed + 1)
        videos, txts, metas = [], [], []
        for s in self._samples():
            video = decode_sample_video(s["mp4"], self.n_frames, self.target_fps, self.size_hw,
                                        self.random_crop, rng)
            if video is None:
                continue
            videos.append(video)
            txts.append(s.get("txt", ""))
            metas.append(s.get("json", {}))
            if len(videos) == self.batch_size:
                batch = np.stack(videos)
                yield {"video": normalize_video(batch) if self.normalize else batch, "txt": txts,
                       "json": metas}
                videos, txts, metas = [], [], []
