"""CSV-indexed mp4 dataset, the v2 precomputed-latent dataset, and the
trainer's prefetcher.

Port of t2v_turbo_tpu/data/datasets.py, a rebuild of the reference's
data/mp4_dataset.py: MP4Dataset (a CSV of video paths and captions ->
decoded clips) and MP4LatentDataset (pickled dicts of {index, z_t,
cond_teacher_out, uncond_teacher_out, score, prompt_emb, use_motion_guide,
short_txt} written by the preprocess jobs). Local paths, or s3:// URIs
through boto3 (imported only for them). A failed read retries on a random
other row (reference mp4_dataset.py:74-80, 137-153), a bounded number of
times.

`DevicePrefetcher` departs from the JAX one on one point: an exception in
its worker reaches the consumer, where the JAX worker's stop marker ended
the iteration as if the data had run out.
"""

from __future__ import annotations

import csv
import io
import pickle
import queue
import random
import tempfile
import threading
from typing import Callable, Iterator, List, Sequence

import numpy as np

from . import videoio
from .transforms import normalize_video, resize_crop


def _read_bytes(path: str) -> bytes:
    if path.startswith("s3://"):
        import boto3  # optional: only s3:// paths need it

        bucket, _, key = path[5:].partition("/")
        buf = io.BytesIO()
        boto3.client("s3").download_fileobj(bucket, key, buf)
        return buf.getvalue()
    with open(path, "rb") as f:
        return f.read()


def read_csv_index(csv_path: str, path_col="path", text_col="text") -> List[dict]:
    with open(csv_path) as f:
        return [{"path": row[path_col], "text": row.get(text_col, "")} for row in csv.DictReader(f)]


class MP4Dataset:
    """Rows of {path, text} -> {video (T,H,W,3) f32 [-1,1], text}. Loads the
    native decoder when constructed (raises if it cannot)."""

    def __init__(
        self,
        rows: Sequence[dict],
        n_frames=16,
        target_fps=8.0,
        size_hw=(320, 512),
        random_crop=True,
        seed=0,
        max_retries=10,
    ):
        videoio.load()
        self.rows = list(rows)
        self.n_frames = n_frames
        self.target_fps = target_fps
        self.size_hw = tuple(size_hw)
        self.random_crop = random_crop
        self.seed = seed
        self.max_retries = max_retries

    def __len__(self):
        return len(self.rows)

    def _decode(self, path: str, seed: int) -> np.ndarray:
        if not path.startswith("s3://"):
            return videoio.decode(path, self.n_frames, self.target_fps, self.random_crop, seed)
        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(_read_bytes(path))
            f.flush()
            return videoio.decode(f.name, self.n_frames, self.target_fps, self.random_crop, seed)

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + i)
        pyrng = random.Random(self.seed + i)
        for attempt in range(self.max_retries):
            row = self.rows[i if attempt == 0 else pyrng.randrange(len(self.rows))]
            try:
                video = self._decode(row["path"], int(rng.randint(2**31 - 1)))
                video = resize_crop(video, self.size_hw, random_crop=self.random_crop, rng=rng)
            except (IOError, ValueError):
                continue
            return {"video": normalize_video(video), "text": row.get("text", "")}
        raise IOError(f"MP4Dataset: {self.max_retries} failed attempts near row {i}")

    def batches(self, batch_size: int, shuffle=True, loop=True) -> Iterator[dict]:
        order = list(range(len(self)))
        rng = random.Random(self.seed)
        while True:
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[j] for j in order[i : i + batch_size]]
                yield {"video": np.stack([it["video"] for it in items]), "text": [it["text"] for it in items]}
            if not loop:
                return


class MP4LatentDataset:
    """v2 training data: pickled latent / teacher / score dicts, one file a
    sample (fields of reference train_latent_t2v_turbo_v2.py:975-992). The
    pickles must come from this program's own preprocessing: unpickling
    runs code."""

    REQUIRED = ("index", "z_t", "cond_teacher_out", "uncond_teacher_out", "prompt_emb")

    def __init__(self, paths: Sequence[str], seed=0, max_retries=10):
        self.paths = list(paths)
        self.seed = seed
        self.max_retries = max_retries

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> dict:
        pyrng = random.Random(self.seed + i)
        for attempt in range(self.max_retries):
            p = self.paths[i if attempt == 0 else pyrng.randrange(len(self.paths))]
            try:
                d = pickle.loads(_read_bytes(p))
            except Exception:  # an unreadable or corrupt pickle raises anything: resample
                continue
            if isinstance(d, dict) and all(k in d for k in self.REQUIRED):
                return apply_latent_defaults(d)
        raise IOError(f"MP4LatentDataset: {self.max_retries} failures near {i}")

    def batches(self, batch_size: int, shuffle=True, loop=True, part=(0, 1)) -> Iterator[dict]:
        """Batches of `batch_size` samples in a seeded shuffled order; with
        part = (index, count) the rows [index * batch_size, (index + 1) *
        batch_size) of each batch of count * batch_size in that order (a data
        rank's share of the global batch: the one-process stream's rows)."""
        index, count = part
        order = list(range(len(self)))
        rng = random.Random(self.seed)
        step = batch_size * count
        while True:
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - step + 1, step):
                lo = i + index * batch_size
                yield collate_latent_batch([self[j] for j in order[lo:lo + batch_size]])
            if not loop:
                return


def apply_latent_defaults(d: dict) -> dict:
    """Default the optional v2-latent fields in place (shared by
    MP4LatentDataset and webdata.LatentWebDataset, so the two loaders
    cannot drift)."""
    d.setdefault("score", np.zeros_like(d["z_t"]))
    d.setdefault("use_motion_guide", True)
    d.setdefault("txt", "")
    # "" means no short caption (the reference keys its short-caption
    # preference on short_txt != "", train_latent_t2v_turbo_v2.py:1077-1081)
    d.setdefault("short_txt", "")
    return d


def collate_latent_batch(items: Sequence[dict]) -> dict:
    """Stack v2-latent samples into the trainer's batch schema."""
    out = {}
    for k in ("index", "z_t", "cond_teacher_out", "uncond_teacher_out", "score", "prompt_emb"):
        out[k] = np.stack([np.asarray(it[k]) for it in items])
    out["use_motion_guide"] = np.asarray([bool(it["use_motion_guide"]) for it in items])
    out["txt"] = [it["txt"] for it in items]
    out["short_txt"] = [it["short_txt"] for it in items]
    return out


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class DevicePrefetcher:
    """Runs `put(batch)` for the next batches of `it` on a worker thread,
    up to `depth` ahead of the consumer, so host-side decode, encode and
    the copy to the device overlap the step (the reference left this to
    torch DataLoader workers). CUDA work in `put` runs on the worker's
    current stream, the default one. An exception raised by `it` or `put`
    is raised again by `__next__`, after the batches before it; then the
    iteration ends. `close()` stops the worker."""

    def __init__(self, it: Iterator, put: Callable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = object()
        self._closed = threading.Event()
        self._done = False

        def worker():
            try:
                for batch in it:
                    item = put(batch)
                    if not self._offer(item):
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                self._offer(_Raised(e))
                return
            self._offer(self._stop)

        self._thread = threading.Thread(target=worker, name="DevicePrefetcher", daemon=True)
        self._thread.start()

    def _offer(self, item) -> bool:
        """Queue `item` unless closed first; False when closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._stop:
            self._done = True
            raise StopIteration
        if isinstance(item, _Raised):
            self._done = True
            raise item.exc
        return item

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker after the batch it is preparing, drop what it
        queued, and wait up to `timeout` s for it to end."""
        self._closed.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
