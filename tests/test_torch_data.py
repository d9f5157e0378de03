"""The port's data layer (t2v_turbo_tpu_torch/data) against the JAX
package's (t2v_turbo_tpu/data), on the CPU: the PIL-free resize bit for bit
against the JAX transforms (which resize with PIL), crops, normalisation and
filters; decode, probe and windowed decode bit for bit on mp4s the JAX
binding writes (skipped where the native library cannot be built, as
tests/test_data.py does); shard resampling; every dataset's batches; the
prefetcher; the launch counters under threads.
"""

import csv
import io
import itertools
import os
import pickle
import sys
import tarfile
import threading
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.data import datasets as jds
from t2v_turbo_tpu.data import transforms as jtr
from t2v_turbo_tpu.data import videoio as jvio
from t2v_turbo_tpu.data import webdata as jwd
from t2v_turbo_tpu_torch.data import datasets as pds
from t2v_turbo_tpu_torch.data import transforms as ptr
from t2v_turbo_tpu_torch.data import videoio as pvio
from t2v_turbo_tpu_torch.data import webdata as pwd

NATIVE = jvio.available() and pvio.available()
native = pytest.mark.skipif(not NATIVE, reason="native videoio not built")


def _frames(t, h, w, seed=0):
    return (np.random.RandomState(seed).rand(t, h, w, 3) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

# (input H, W) -> the short side resize_video is asked for: WebVid's 16:9
# sources into 320x512 (-> 320x569), an upscale, and a 1-pixel growth
RESIZES = [((360, 640), 320), ((480, 854), 320), ((720, 1280), 320), ((240, 427), 320), ((320, 512), 321)]


@pytest.mark.parametrize("hw,short", RESIZES, ids=[f"{h}x{w}" for (h, w), _ in RESIZES])
def test_resize_video_bit_exact_with_jax(hw, short):
    video = _frames(2, *hw)
    got, ref = ptr.resize_video(video, short), jtr.resize_video(video, short)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_resize_bit_exact_with_pil_both_axes():
    """100x37 -> 333x123 (upscale by a different factor on each axis): the
    size resize_video cannot ask for, held to the PIL call the JAX
    transform makes."""
    video = _frames(2, 100, 37, seed=1)
    got = ptr.resize_image_bilinear(video, (333, 123))
    ref = np.stack([np.asarray(Image.fromarray(f).resize((123, 333), Image.BILINEAR)) for f in video])
    np.testing.assert_array_equal(got, ref)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), short=st.integers(1, 64), seed=st.integers(0, 2**16))
def test_resize_video_bit_exact_drawn(h, w, short, seed):
    video = _frames(1, h, w, seed)
    np.testing.assert_array_equal(ptr.resize_video(video, short), jtr.resize_video(video, short))


@pytest.mark.parametrize("random_crop", [False, True])
def test_resize_crop_and_normalize_equal_jax(random_crop):
    video = _frames(3, 90, 160, seed=2)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    got = ptr.resize_crop(video, (64, 96), random_crop=random_crop, rng=r1)
    ref = jtr.resize_crop(video, (64, 96), random_crop=random_crop, rng=r2)
    np.testing.assert_array_equal(got, ref)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)  # the same draws were taken
    np.testing.assert_array_equal(ptr.normalize_video(got), jtr.normalize_video(ref))
    np.testing.assert_array_equal(ptr.crop_video(video, 50, 70), jtr.crop_video(video, 50, 70))


def test_filters_equal_jax():
    samples = [{"mp4": b"", "txt": "a"}, {"txt": "b"},
               {"json": {"language": "de", "aesthetic": 3.0, "p_unsafe": 0.999}},
               {"json": {"lang": "en", "AESTHETIC_SCORE": 6.0, "punsafe": 0.1}}, {"json": None}]
    for name, kw in (("KeyFilter", {}), ("LanguageFilter", {}), ("AestheticsFilter", {"min_score": 5.0}),
                     ("UnsafeFilter", {})):
        port, ref = getattr(ptr, name)(**kw), getattr(jtr, name)(**kw)
        assert [port(s) for s in samples] == [ref(s) for s in samples], name


# ---------------------------------------------------------------------------
# native decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mp4s(tmp_path_factory):
    """Two mp4s written by the JAX binding (widths whose rows are whole
    32-byte vectors: the JAX binding overruns its buffer at others)."""
    d = tmp_path_factory.mktemp("mp4s")
    paths = []
    for i, (t, h, w, fps) in enumerate(((24, 64, 96, 8), (30, 48, 64, 12))):
        p = str(d / f"v{i}.mp4")
        jvio.encode(p, _frames(t, h, w, seed=10 + i), fps=fps)
        paths.append(p)
    return paths


@native
def test_probe_decode_and_window_bit_exact_with_jax(mp4s):
    for p in mp4s:
        assert pvio.probe(p) == pvio.VideoInfo(**jvio.probe(p).__dict__)
        for kw in (dict(n_frames=8, target_fps=4), dict(n_frames=6, target_fps=8, random_offset=True, seed=7),
                   dict(n_frames=5, width=32, height=16), dict(n_frames=4, target_fps=0.0)):
            np.testing.assert_array_equal(pvio.decode(p, **kw), jvio.decode(p, **kw))
        for start, n, stride in ((0, 4, 1), (3, 5, 2)):
            np.testing.assert_array_equal(pvio.decode_window(p, start, n, stride),
                                          jvio.decode_window(p, start, n, stride))


@native
def test_scene_helpers_equal_jax(mp4s):
    frames = pvio.decode(mp4s[1], n_frames=30, target_fps=0.0)
    frames[12:] = 0  # a cut at frame 12: noise, then black
    cuts = pvio.detect_cuts(frames)
    np.testing.assert_array_equal(cuts, jvio.detect_cuts(frames))
    assert cuts.tolist() == [[0, 12], [12, 30]]
    np.testing.assert_array_equal(pvio.sample_scene_clip(cuts, 4, 2, seed=3), jvio.sample_scene_clip(cuts, 4, 2, seed=3))
    np.testing.assert_array_equal(pvio.decode_scene_aware(mp4s[0], n_frames=4, seed=1),
                                  jvio.decode_scene_aware(mp4s[0], n_frames=4, seed=1))


@native
def test_decode_any_width_and_encode_roundtrip(tmp_path):
    """Widths whose rows are not whole vectors (40 and 37 pixels) decode
    into a buffer with spare bytes after the frames."""
    p = str(tmp_path / "odd.mp4")
    src = _frames(6, 24, 40, seed=4)
    pvio.encode(p, src, fps=8)
    assert pvio.probe(p).width == 40
    out = pvio.decode(p, n_frames=4, target_fps=0.0)
    assert out.shape == (4, 24, 40, 3) and out.base.size >= out.size + pvio._SWS_SLACK
    assert abs(float(out.mean()) - float(src[:4].mean())) < 5  # a lossy codec keeps the mean
    assert pvio.decode(p, n_frames=3, width=37, height=11).shape == (3, 11, 37, 3)
    with pytest.raises(IOError):
        pvio.decode(str(tmp_path / "missing.mp4"), 4)
    dec = pvio.VideoDecoder(n_frames=2, target_fps=0.0, workers=2)
    try:
        got = dec.decode_batch([p, str(tmp_path / "missing.mp4")])
    finally:
        dec.close()
    assert got[0].shape == (2, 24, 40, 3) and got[1] is None


def test_build_names_missing_libav(tmp_path, monkeypatch):
    """A build whose compiler cannot find libav raises and names what is
    missing; nothing is left behind."""
    cxx = tmp_path / "fake-g++"
    cxx.write_text("#!/bin/sh\necho 'videoio.cpp:21:10: fatal error: libavcodec/avcodec.h: "
                   "No such file or directory' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(pvio, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"libavformat.*missing headers \['libavcodec/avcodec\.h'\]"):
        pvio.build()
    (leftover,) = os.listdir(tmp_path / "build")
    assert os.listdir(tmp_path / "build" / leftover) == []


def test_datasets_raise_at_construction_without_decoder(tmp_path, monkeypatch):
    def no_library():
        raise RuntimeError("the native video library needs libav's headers and libraries")

    monkeypatch.setattr(pvio, "load", no_library)
    with pytest.raises(RuntimeError, match="libav"):
        pwd.WebVideoDataset([str(tmp_path / "a.tar")])
    with pytest.raises(RuntimeError, match="libav"):
        pds.MP4Dataset([{"path": str(tmp_path / "a.mp4"), "text": ""}])


# ---------------------------------------------------------------------------
# shards and datasets
# ---------------------------------------------------------------------------


def test_resample_shards_by_prefix_equal_jax():
    shards = [f"/d/a/{i}.tar" for i in range(3)] + [f"/d/b/{i}.tar" for i in range(5)]
    w = {"/d/a": 1.0, "/d/b": 3.0, "/d/c": 2.0}
    got = list(itertools.islice(pwd.resample_shards_by_prefix(shards, w, seed=4), 60))
    assert got == list(itertools.islice(jwd.resample_shards_by_prefix(shards, w, seed=4), 60))
    for bad, wts in ((shards + ["/x/0.tar"], w), (shards, {"/x": 1.0})):
        with pytest.raises(ValueError) as port_err:
            pwd.resample_shards_by_prefix(bad, wts)
        with pytest.raises(ValueError) as jax_err:
            jwd.resample_shards_by_prefix(bad, wts)
        assert str(port_err.value) == str(jax_err.value)
    assert pwd.split_shards_by_host(shards) == shards  # no process group: rank 0 of 1
    assert pwd.split_shards_by_host(shards, 1, 3) == jwd.split_shards_by_host(shards, 1, 3)


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def video_shards(tmp_path_factory):
    """Two prefixes' tar shards of mp4 + txt (+ json) samples written by the
    JAX binding, one corrupt mp4 among them; and a CSV of the same mp4s."""
    if not NATIVE:
        pytest.skip("native videoio not built")
    d = tmp_path_factory.mktemp("shards")
    rows, shards = [], []
    for prefix, n_shards in (("a", 2), ("b", 1)):
        for s in range(n_shards):
            path = str(d / f"{prefix}_{s}.tar")
            with tarfile.open(path, "w") as tf:
                for i in range(3):
                    key = f"{prefix}{s}_{i}"
                    mp4 = str(d / f"{key}.mp4")
                    jvio.encode(mp4, _frames(12, 48, 64, seed=zlib.crc32(key.encode()) % 1000), fps=8)
                    data = b"not an mp4" if key == "a0_1" else open(mp4, "rb").read()
                    _add(tf, f"{key}.mp4", data)
                    _add(tf, f"{key}.txt", f"caption {key}".encode())
                    _add(tf, f"{key}.json", b'{"aesthetic": 5}')
                    rows.append({"path": mp4, "text": f"caption {key}"})
            shards.append(path)
    index = str(d / "index.csv")
    with open(index, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path", "text"])
        w.writeheader()
        w.writerows(rows)
    return str(d), shards, index


def _assert_batches_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("prefix_weights", [None, "mixture"])
def test_web_video_dataset_equal_jax(video_shards, prefix_weights):
    d, shards, _ = video_shards
    kw = dict(batch_size=2, n_frames=4, size_hw=(32, 40), shuffle_buffer=3,
              prefix_weights={f"{d}/a": 1.0, f"{d}/b": 3.0} if prefix_weights else None)
    port, ref = pwd.WebVideoDataset(shards, **kw), jwd.WebVideoDataset(shards, **kw)
    for got, want in zip(itertools.islice(iter(port), 5), itertools.islice(iter(ref), 5)):
        assert got["video"].shape == (2, 4, 32, 40, 3)
        _assert_batches_equal(got, want)


def test_mp4_dataset_from_csv_equal_jax(video_shards):
    _, _, index = video_shards
    rows = pds.read_csv_index(index)
    assert rows == jds.read_csv_index(index)
    rows[1] = {"path": rows[1]["path"] + ".missing", "text": "gone"}  # resampled
    kw = dict(n_frames=4, size_hw=(32, 40), seed=3)
    port, ref = pds.MP4Dataset(rows, **kw), jds.MP4Dataset(rows, **kw)
    for got, want in zip(itertools.islice(port.batches(2), 3), itertools.islice(ref.batches(2), 3)):
        _assert_batches_equal(got, want)


def _latent_sample(i):
    r = np.random.RandomState(i)
    d = {"index": i, "z_t": r.randn(2, 3).astype(np.float32), "cond_teacher_out": r.randn(2, 3),
         "uncond_teacher_out": r.randn(2, 3), "prompt_emb": r.randn(4, 5).astype(np.float32)}
    if i % 2:
        d.update(score=r.randn(2, 3), use_motion_guide=False, txt=f"t{i}", short_txt="s")
    return d


def test_latent_datasets_equal_jax(tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / f"{i}.pkl"
        p.write_bytes(pickle.dumps(_latent_sample(i)) if i != 2 else b"corrupt")
        paths.append(str(p))
    port, ref = pds.MP4LatentDataset(paths, seed=1), jds.MP4LatentDataset(paths, seed=1)
    for got, want in zip(itertools.islice(port.batches(2), 4), itertools.islice(ref.batches(2), 4)):
        _assert_batches_equal(got, want)
    shards = []
    for s in range(2):
        path = str(tmp_path / f"lat{s}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(4):
                _add(tf, f"{s}_{i}.pickle", pickle.dumps(_latent_sample(10 * s + i)))
            _add(tf, f"{s}_x.pkl", b"corrupt")
            _add(tf, f"{s}_y.txt", b"ignored")
        shards.append(path)
    kw = dict(num_train_examples=10, per_host_batch_size=3, global_batch_size=3, shuffle_buffer_size=4, seed=2)
    port, ref = pwd.LatentWebDataset(shards, **kw), jwd.LatentWebDataset(shards, **kw)
    assert (port.num_batches, port.num_samples) == (ref.num_batches, ref.num_samples) == (4, 12)
    for got, want in zip(itertools.islice(iter(port), 4), itertools.islice(iter(ref), 4)):
        _assert_batches_equal(got, want)


# ---------------------------------------------------------------------------
# the prefetcher and the launch counters
# ---------------------------------------------------------------------------


def test_prefetcher_keeps_order_and_ends():
    seen = []
    with pds.DevicePrefetcher(iter(range(7)), put=lambda x: (seen.append(x), 10 * x)[1]) as pf:
        assert list(pf) == [10 * i for i in range(7)]
        with pytest.raises(StopIteration):
            next(pf)
    assert seen == list(range(7))


def test_prefetcher_reraises_the_workers_exception():
    def batches():
        yield 1
        yield 2
        raise KeyError("decode failed")

    pf = pds.DevicePrefetcher(batches(), put=lambda x: x)
    assert [next(pf), next(pf)] == [1, 2]
    with pytest.raises(KeyError, match="decode failed"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    pf = pds.DevicePrefetcher(iter(range(3)), put=lambda x: 1 / (x - 1))
    assert next(pf) == -1.0
    with pytest.raises(ZeroDivisionError):
        next(pf)
    pf.close()


def test_prefetcher_close_stops_a_blocked_worker():
    pf = pds.DevicePrefetcher(itertools.count(), put=lambda x: x, depth=1)
    assert next(pf) == 0
    pf.close(timeout=10)  # the worker is blocked on a full queue
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_launch_counters_lose_no_update_under_threads():
    """The trainer's data thread and its step thread launch kernels at
    once: the wrappers' counters must count every launch."""
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import norms as N

    old = sys.getswitchinterval()
    saved = (A.flash_attention.launches, A.flash_attention.by_route.copy(), N.fused_group_norm.launches,
             N.fused_group_norm.by_shape.copy())
    before = (A.flash_attention.launches, N.fused_group_norm.launches)
    n_threads, n = 16, 2000

    def work():
        for _ in range(n):
            A._count(A.flash_attention, "test-route", (1, 1, 1, 1, 7))
            N._count(N.fused_group_norm, "test-route", (7,))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n
    assert A.flash_attention.launches - before[0] == total == A.flash_attention.by_route["test-route"]
    assert N.fused_group_norm.launches - before[1] == total == N.fused_group_norm.by_shape[(7,)]
    A.flash_attention.launches, A.flash_attention.by_route, N.fused_group_norm.launches, \
        N.fused_group_norm.by_shape = saved
    A.flash_attention.by_head_dim.pop(7)
    A.flash_attention.by_shape.pop((1, 1, 1, 1, 7))
