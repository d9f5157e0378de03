"""apps/serve.py of the port against the JAX package's, on the CPU, and the
pipeline's chunked decode (`decode_frame_chunk`) against the JAX pipeline's.

- The HTTP surface: the port's server and the JAX server
  (t2v_turbo_tpu.apps.serve.make_server), each around a stub pipeline that
  returns the same seeded numpy video, answer the same requests (the page,
  /healthz, /gallery, POST /generate with and without a prompt, a failing
  pipeline, a missing video, unknown routes) with the same status codes
  and JSON keys. The port's video URL names the file it wrote: .npy
  without an ffmpeg binary, the stub's frames as uint8.
- One lock: two concurrent POSTs never run the pipeline at once, and
  /healthz answers while a video renders.
- Chunked decode: the port's pipeline with decode_frame_chunk=3 (a ragged
  last chunk) against the JAX pipeline's at the same latents (1 step, no
  renoise), at tests/test_torch_pipeline.py's ATOL 3e-4.
"""

import io
import json
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.apps import serve as jserve
from t2v_turbo_tpu_torch.apps import serve as pserve
from test_torch_pipeline import ATOL, pipelines  # noqa: F401

FRAMES = np.random.RandomState(0).uniform(-1, 1, (1, 4, 32, 32, 3)).astype(np.float32)


class PortStub:
    device = "cpu"

    def __init__(self):
        self.active = self.most = self.calls = 0
        self.release = threading.Event()
        self.release.set()
        self.lock = threading.Lock()

    def __call__(self, prompt=None, **kw):
        with self.lock:
            self.active += 1
            self.calls += 1
            self.most = max(self.most, self.active)
        try:
            if prompt == "fail":
                raise ValueError("artifact pipeline is compiled for frames=4; got 8.")
            self.release.wait(30)
            time.sleep(0.05)
            return torch.from_numpy(FRAMES)
        finally:
            with self.lock:
                self.active -= 1


class JaxStub:
    _sample_jit_cache = {(4, 50, False, 0.3): None}

    def __call__(self, prompt=None, **kw):
        import jax.numpy as jnp

        if prompt == "fail":
            raise ValueError("artifact pipeline is compiled for frames=4; got 8.")
        return jnp.asarray(FRAMES)


def _start(make_server, pipe, out_dir):
    class A:
        host, port, output_dir, height, width, frames = "127.0.0.1", 0, str(out_dir), 32, 32, 4

    srv = make_server(pipe, A())
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    port_pipe = PortStub()
    both = {"port": _start(pserve.make_server, port_pipe, tmp_path_factory.mktemp("port")),
            "jax": _start(jserve.make_server, JaxStub(), tmp_path_factory.mktemp("jax"))}
    yield {k: url for k, (_, url) in both.items()}, port_pipe
    for srv, _ in both.values():
        srv.shutdown()


def _request(url, path, body=None):
    """(status, content type, body bytes) of a GET, or of a POST of `body`."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


REQUESTS = [
    ("page", "/", None),
    ("healthz", "/healthz", None),
    ("generate", "/generate", {"prompt": "a cat", "frames": 4, "height": 32, "width": 32, "seed": 3}),
    ("gallery", "/gallery", None),
    ("missing prompt", "/generate", b"{}"),
    ("pipeline error", "/generate", {"prompt": "fail"}),
    ("missing video", "/videos/nothere.mp4", None),
    ("unknown GET", "/nope", None),
    ("unknown POST", "/nope", {"prompt": "a cat"}),
]


def test_same_status_codes_and_json_keys(servers):
    urls, _ = servers
    for what, path, body in REQUESTS:
        got = {k: _request(url, path, body) for k, url in urls.items()}
        assert got["port"][0] == got["jax"][0], (what, got["port"][0], got["jax"][0])
        if what == "page":
            assert b"/generate" in got["port"][2] and "text/html" in got["port"][1]
            continue
        port, jax = (json.loads(got[k][2]) for k in ("port", "jax"))
        if isinstance(jax, list):
            port, jax = port[-1], jax[-1]
        assert set(port) == set(jax), (what, sorted(port), sorted(jax))
        if what == "generate":
            assert port["shape"] == jax["shape"] == [4, 32, 32, 3]
            assert port["prompt"] == "a cat" and port["latency_s"] >= 0
        if what == "pipeline error":
            assert port["error"] == jax["error"]


def test_video_url_names_the_file_written(servers):
    urls, _ = servers
    _, _, body = _request(urls["port"], "/generate", {"prompt": "a dog", "seed": 1})
    out = json.loads(body)
    ext = ".mp4" if shutil.which("ffmpeg") else ".npy"
    assert out["video_url"] == "/videos/" + out["path"].rsplit("/", 1)[1] and out["video_url"].endswith(ext)
    code, ctype, data = _request(urls["port"], out["video_url"])
    assert code == 200
    if ext == ".npy":
        assert ctype == "application/octet-stream"
        want = (np.clip((FRAMES[0] + 1) / 2, 0, 1) * 255).round().astype(np.uint8)
        np.testing.assert_array_equal(np.load(io.BytesIO(data)), want)
    code, _, body = _request(urls["port"], "/healthz")
    assert [4, 32, 32, 4, 50] in json.loads(body)["compiled_shapes"]


def test_one_lock_serialises_the_pipeline(servers):
    urls, stub = servers
    stub.release.clear()
    calls = stub.calls
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(
        _request(urls["port"], "/generate", {"prompt": f"p{i}", "seed": i}))) for i in range(2)]
    for t in threads:
        t.start()
    deadline = time.time() + 30
    while stub.calls == calls and time.time() < deadline:
        time.sleep(0.01)
    code, _, body = _request(urls["port"], "/healthz")  # answered while a video renders
    assert code == 200 and json.loads(body)["status"] == "ok" and stub.active == 1
    stub.release.set()
    for t in threads:
        t.join(60)
    assert [r[0] for r in results] == [200, 200]
    assert stub.most == 1 and stub.calls == calls + 2


def test_parse_args_refuses_shards_and_defaults_to_the_card():
    args = pserve.parse_args(["--backbone", "ms", "--ms-dir", "/tmp/msdir", "--random-weights"])
    assert (args.backbone, args.ms_dir, args.device) == ("ms", "/tmp/msdir", "cuda:0")
    with pytest.raises(SystemExit):
        pserve.build_server(["--random-weights", "--seq-shards", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pserve.build_server(["--random-weights"])


def test_chunked_decode_matches_jax(pipelines):  # noqa: F811
    import jax
    import jax.numpy as jnp

    port, ref = pipelines
    lat = np.random.RandomState(12).randn(1, 4, 4, 4, 4).astype(np.float32)
    kw = dict(prompt="a cat", height=8, width=8, frames=4, num_inference_steps=1, decode_frame_chunk=3)
    want = np.asarray(ref(key=jax.random.PRNGKey(5), latents=jnp.asarray(lat), **kw))
    got = port(latents=torch.from_numpy(lat), **kw)
    assert got.shape == (1, 4, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    whole = port(latents=torch.from_numpy(lat), **{**kw, "decode_frame_chunk": None})
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL)
