"""HTTP serving app (port of t2v_turbo_tpu/apps/serve.py): the reference's
gradio demo surface (app.py / app_ms.py) as a dependency-free JSON API plus
a static browser UI.

  python -m t2v_turbo_tpu_torch.apps.serve --random-weights --port 7860

  GET  /          -> browser demo (prompt box, knobs, examples, gallery)
  POST /generate {"prompt": "...", "steps": 4, "frames": 16, "seed": 123,
                  "guidance_scale": 7.5, "fps": 16, "decode_frame_chunk": 16}
    -> {"path": "outputs/xxxx.mp4", "video_url": "/videos/xxxx.mp4",
        "prompt": ..., "latency_s": ..., "shape": [T, H, W, 3]}
  GET  /videos/<name> -> the rendered clip
  GET  /gallery -> JSON list of the generations since the server started
  GET  /healthz -> {"status": "ok", "device": "...", "compiled_shapes": [...]}

The pipeline runs on --device (default cuda:0) in bf16 with the
hand-written kernels; one lock serialises its calls, while the threading
server keeps answering /healthz and the gallery. A video is written as
.mp4 where an `ffmpeg` binary is on the PATH, else as .npy (io/video.py),
and `video_url` names the file written. `latency_s` runs from the request
to the written file, the wait for the lock included. `compiled_shapes`
lists the operating points (frames, height, width, steps, lcm_origin_steps)
served so far, or the artifacts' one.

With --artifacts DIR the server loads the `warmup --export` programs
(pipelines/artifact.py) instead of the model code: requests are bound to
the exported operating point. Their weights come from --checkpoint (a
VideoCrafter2 checkpoint's state dicts, through io/convert.py's key maps,
no module built), --ms-dir (the ModelScope folder's) or --random-weights
(smoke mode: the seeded modules of generate --random-weights, which does
build the model code).

Sharded (VC2, one process per rank under torchrun; the JAX server's
--data-shards / --seq-shards): every rank builds the pipeline over the mesh
(apps/generate.py::make_cli_mesh); rank 0 serves HTTP and, for each request,
broadcasts the prompt and parameters to every rank, all ranks sample, and
rank 0 answers. The other ranks `follow`: they run what rank 0 broadcasts
until it broadcasts the shutdown; while idle, rank 0 broadcasts a heartbeat
every HEARTBEAT_S, so no rank's wait outlasts the process group's timeout.
  torchrun --nproc-per-node 2 -m t2v_turbo_tpu_torch.apps.serve --random-weights --seq-shards 2
--model-shards above 1 (tensor parallelism) is A12b and refused; the
`warmup --export` artifacts serve on one rank, and shards with --artifacts
are refused.

Not here: the JAX server's persistent compile cache (the port compiles
nothing but its kernels, which `warmup` builds ahead of time).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

# Example prompts: the reference demo's flavour, from training/validation.py's set.
_EXAMPLE_PROMPTS = [
    "An astronaut riding a horse.",
    "A cat eating food out of a bowl, in style of van Gogh.",
    "A dog wearing a superhero outfit with red cape flying through the sky.",
    "A panda drinking coffee in a cafe in Paris.",
    "A musk ox grazing on beautiful wildflowers.",
]

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>T2V-Turbo</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:880px;margin:2rem auto;
      padding:0 1rem;color:#222}
 h1{font-size:1.4rem} .row{display:flex;gap:.6rem;flex-wrap:wrap;
      align-items:center;margin:.4rem 0}
 textarea{width:100%;height:3.2rem;font-size:1rem;padding:.4rem}
 label{font-size:.85rem;color:#555} input[type=number]{width:5.5rem}
 button{padding:.5rem 1.2rem;font-size:1rem;cursor:pointer}
 .ex{cursor:pointer;color:#06c;font-size:.85rem;margin-right:.8rem}
 #status{color:#777;font-size:.9rem;min-height:1.2rem}
 #gallery{display:flex;flex-wrap:wrap;gap:.8rem;margin-top:1rem}
 #gallery figure{margin:0;width:256px}
 #gallery video{width:100%;border-radius:6px;background:#000}
 #gallery figcaption{font-size:.75rem;color:#666;word-break:break-word}
</style></head><body>
<h1>T2V-Turbo &mdash; text to video</h1>
<textarea id="prompt" placeholder="Describe the video..."></textarea>
<div class="row" id="examples"></div>
<div class="row">
 <label>steps <input id="steps" type="number" value="4" min="1" max="16"></label>
 <label>frames <input id="frames" type="number" value="16" min="8" max="48"></label>
 <label>guidance <input id="gs" type="number" value="7.5" step="0.5"></label>
 <label>seed <input id="seed" type="number" value="123"></label>
 <label>fps <input id="fps" type="number" value="16" min="8" max="32"></label>
 <button id="go">Generate</button>
</div>
<div id="status"></div>
<div id="gallery"></div>
<script>
const EXAMPLES = %EXAMPLES%;
const ex = document.getElementById('examples');
EXAMPLES.forEach(p => { const a=document.createElement('span');
  a.className='ex'; a.textContent=p;
  a.onclick=()=>{document.getElementById('prompt').value=p;}; ex.appendChild(a);});
async function refresh(){
  const g = await (await fetch('/gallery')).json();
  const el = document.getElementById('gallery'); el.innerHTML='';
  g.slice().reverse().forEach(it => {
    const f=document.createElement('figure');
    f.innerHTML = it.video_url.endsWith('.mp4')
      ? `<video src="${it.video_url}" controls loop muted autoplay></video>`
      : `<a href="${it.video_url}">${it.video_url}</a>`;
    f.innerHTML += `<figcaption>${it.prompt} &mdash; ${it.latency_s}s</figcaption>`;
    el.appendChild(f);});
}
document.getElementById('go').onclick = async () => {
  const s=document.getElementById('status');
  const body={prompt:document.getElementById('prompt').value,
    steps:+document.getElementById('steps').value,
    frames:+document.getElementById('frames').value,
    guidance_scale:+document.getElementById('gs').value,
    seed:+document.getElementById('seed').value,
    fps:+document.getElementById('fps').value};
  if(!body.prompt){s.textContent='enter a prompt';return;}
  s.textContent='generating...';
  const r=await fetch('/generate',{method:'POST',body:JSON.stringify(body)});
  const j=await r.json();
  s.textContent = r.ok ? `done in ${j.latency_s}s` : `error: ${j.error}`;
  refresh();
};
refresh();
</script></body></html>"""

_VIDEO_TYPES = {".mp4": "video/mp4", ".npy": "application/octet-stream"}
# Sharded: while idle, rank 0 broadcasts a heartbeat this often, well inside
# the process group's timeout (parallel/multihost.py DEFAULT_TIMEOUT_S) that
# every other rank's wait for the next request is held to.
HEARTBEAT_S = 60.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo server (PyTorch port)")
    p.add_argument("--backbone", default="vc2", choices=["vc2", "ms"],
                   help="VideoCrafter2 (app.py parity) or ModelScope (app_ms.py parity)")
    p.add_argument("--ms-dir", default=None, help="diffusers multi-file dir for --backbone ms")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--unet-ckpt", default=None)
    p.add_argument("--lora-ckpt", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--artifacts", default=None, metavar="DIR",
                   help="serve from `warmup --export DIR` programs instead of live modules: no model code "
                        "runs the requests. Requests are bound to the artifacts' operating point "
                        "(steps/frames/height/width).")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--tiny", action="store_true", help="tiny dims for smoke")
    from .generate import add_mesh_args

    add_mesh_args(p)
    return p.parse_args(argv)


def _artifact_state_dicts(args, op):
    """(unet, vae, text) state dicts for the artifacts' operating point."""
    if args.checkpoint:
        from ..io.convert import load_checkpoint, split_vc2_checkpoint

        unet_sd, vae_sd, text_sd = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
        if args.unet_ckpt:
            unet_sd = load_checkpoint(args.unet_ckpt)
        if args.lora_ckpt:
            from ..config import vc2_spec
            from ..io.lora_import import apply_lora_pt, load_lora_pt

            if not args.lora_ckpt.endswith(".pt"):
                raise ValueError("--artifacts folds a unet_lora.pt only; fold an .npz into a unet.pt first")
            cfg = vc2_spec(motion_cond=op["use_motion_cond"]).unet
            unet_sd = apply_lora_pt(unet_sd, load_lora_pt(args.lora_ckpt), cfg)
        return unet_sd, vae_sd, text_sd
    if args.ms_dir:
        from ..io.convert import load_checkpoint
        from ..io.ms import load_ms_components, ms_unet_state_dict
        from ..models.unet_ms import MSUNetConfig

        comps = load_ms_components(args.ms_dir)
        ucfg = MSUNetConfig(time_cond_proj_dim=256)
        unet_sd = ms_unet_state_dict(load_checkpoint(args.unet_ckpt) if args.unet_ckpt else comps["unet"], ucfg)
        if args.lora_ckpt:
            from ..io.lora_import import apply_lora_pt_ms, load_lora_pt

            unet_sd = apply_lora_pt_ms(unet_sd, load_lora_pt(args.lora_ckpt), ucfg)
        return unet_sd, comps["vae"], comps["text"]
    if args.random_weights:
        # smoke mode: generate --random-weights --seed 0's modules at the
        # artifacts' configs (this path builds the model code)
        from . import warmup

        wargs = warmup.parse_args(["--backbone", op["backbone"]] + (["--tiny-model"] if op["tiny_model"] else [])
                                  + (["--f32"] if op["dtype"] == "float32" else [])
                                  + (["--use-motion-cond"] if op["use_motion_cond"] else []))
        pipe, _ = warmup.build_pipeline(wargs, device=args.device, seed=0)
        return pipe.unet.state_dict(), pipe.vae.state_dict(), pipe.text_model.state_dict()
    raise SystemExit("error: --artifacts needs --checkpoint, --ms-dir or --random-weights")


def build_artifact_pipeline(args):
    """ArtifactPipeline from --artifacts DIR and the weights' state dicts."""
    import numpy as np

    from ..pipelines.artifact import ArtifactPipeline
    from ..utils.tokenizer import CLIPTokenizer

    with open(os.path.join(args.artifacts, "manifest.json")) as f:
        op = json.load(f)["operating_point"]
    unet_sd, vae_sd, text_sd = _artifact_state_dicts(args, op)
    if op["ctx_len"] == 77:
        tokenizer = CLIPTokenizer()
    else:  # tiny exports' toy text config: zero tokens suffice
        def tokenizer(prompt):
            n = 1 if isinstance(prompt, str) else len(prompt)
            return np.zeros((n, op["ctx_len"]), np.int32)
    return ArtifactPipeline.from_dir(args.artifacts, unet_sd=unet_sd, vae_sd=vae_sd, text_sd=text_sd,
                                     tokenizer=tokenizer, device=args.device)


def build_server(argv=None, spec=None):
    """The flags -> (server, pipeline, args): the pipeline built as the
    flags ask (live or from artifacts) and `make_server` around it, not yet
    serving. Sharded, on a rank other than 0 the server is None: that rank
    `follow`s. `spec` replaces the VC2 configs (tests pass small ones)."""
    args = parse_args(argv)
    if args.tiny:
        args.height, args.width, args.frames = 128, 128, 8
    shards = {n: getattr(args, n) for n in ("data_shards", "seq_shards", "model_shards")}
    if args.artifacts and (any(v != 1 for v in shards.values()) or args.multihost):
        raise SystemExit(f"error: warmup --export artifacts serve on one rank; shards {shards} need the live "
                         "pipeline (drop --artifacts)")
    from .generate import build_pipeline, make_cli_mesh

    mesh = make_cli_mesh(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu to serve on the CPU)")
    if args.artifacts:
        pipe = build_artifact_pipeline(args)
    else:
        args.seed = 0  # --random-weights: generate's seeded weights at seed 0
        pipe = build_pipeline(args, spec, mesh)
    if mesh is not None and mesh.rank != 0:
        return None, pipe, args
    return make_server(pipe, args), pipe, args


def main(argv=None, spec=None):
    server, pipe, args = build_server(argv, spec)
    mesh = getattr(pipe, "mesh", None)
    try:
        if server is None:
            follow(pipe)
            return
        print(f"serving on http://{args.host}:{server.server_address[1]} (device {pipe.device})", flush=True)
        try:
            server.serve_forever()
        finally:
            stop(server)
    finally:
        if mesh is not None:
            from ..parallel import multihost

            multihost.shutdown()


def _broadcast(mesh, msg=None):
    """Rank 0's `msg` on every rank of the mesh."""
    import torch.distributed as dist

    box = [msg]
    dist.broadcast_object_list(box, src=mesh.axis("world").ranks[0])
    return box[0]


class RankRelay:
    """Rank 0's side of a sharded server: each request (and, while idle, a
    heartbeat every `heartbeat_s`, and the shutdown) to the other ranks,
    under the server's pipeline lock."""

    def __init__(self, mesh, lock: threading.Lock, heartbeat_s: float):
        self.mesh, self.lock, self.closed = mesh, lock, False
        self._stop = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, args=(heartbeat_s,), daemon=True)
        self._beat.start()

    def send(self, msg) -> None:
        """Broadcast `msg`; the caller holds the lock."""
        _broadcast(self.mesh, msg)

    def _heartbeat(self, every: float) -> None:
        while not self._stop.wait(every):
            with self.lock:
                if not self.closed:
                    self.send({"op": "ping"})

    def close(self) -> None:
        """Stop the heartbeat and release the other ranks (once)."""
        self._stop.set()
        self._beat.join(timeout=60)
        with self.lock:
            if not self.closed:
                self.closed = True
                self.send({"op": "stop"})


def follow(pipe) -> None:
    """A rank other than 0 of a sharded server: sample every request rank 0
    broadcasts (every rank takes part in the collectives), until rank 0
    broadcasts the shutdown. A request that fails here is reported and the
    rank goes on following (rank 0 answers the error)."""
    while True:
        msg = _broadcast(pipe.mesh)
        if msg["op"] == "stop":
            return
        if msg["op"] == "generate":
            try:
                pipe(generator=torch.Generator(device=pipe.device).manual_seed(msg["seed"]), **msg["call"])
            except Exception:  # noqa: BLE001  (the follower loop must keep running)
                traceback.print_exc()


def stop(server) -> None:
    """Release a sharded server's other ranks (no-op on one rank)."""
    relay = getattr(server, "relay", None)
    if relay is not None:
        relay.close()


def make_server(pipe, args) -> ThreadingHTTPServer:
    """The HTTP server around any pipeline object (the live pipeline, the
    artifact pipeline, or a test's stub): one lock serialises its calls.
    Around a pipeline over a mesh of several ranks it also relays each
    request to the other ranks (`RankRelay`, as `server.relay`)."""
    from ..io.video import save_video
    # pipelines.artifact's copy: importing pipelines.vc2 would pull the
    # model code onto a host that serves artifacts
    from ..pipelines.artifact import video_to_uint8

    os.makedirs(args.output_dir, exist_ok=True)
    device = torch.device(getattr(pipe, "device", "cpu"))
    ext = ".mp4" if shutil.which("ffmpeg") else ".npy"
    lock = threading.Lock()
    mesh = getattr(pipe, "mesh", None)
    relay = RankRelay(mesh, lock, HEARTBEAT_S) if mesh is not None and mesh.size > 1 else None
    gallery: list = []
    points = set(getattr(pipe, "operating_points", ()))  # live: the points served so far
    index_html = _INDEX_HTML.replace("%EXAMPLES%", json.dumps(_EXAMPLE_PROMPTS)).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _bytes(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._bytes(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                return self._bytes(200, index_html, "text/html; charset=utf-8")
            if self.path == "/healthz":
                return self._json(200, {"status": "ok", "device": str(device),
                                        "compiled_shapes": [list(p) for p in sorted(points)]})
            if self.path == "/gallery":
                return self._json(200, gallery)
            if self.path.startswith("/videos/"):
                name = os.path.basename(self.path)
                fp = os.path.join(args.output_dir, name)
                ctype = _VIDEO_TYPES.get(os.path.splitext(name)[1])
                if ctype and os.path.exists(fp):
                    with open(fp, "rb") as f:
                        return self._bytes(200, f.read(), ctype)
                return self._json(404, {"error": "no such video"})
            self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})
            try:
                t0 = time.perf_counter()
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req.get("prompt")
                if not prompt:
                    return self._json(400, {"error": "missing 'prompt'"})
                kw = dict(height=int(req.get("height", args.height)), width=int(req.get("width", args.width)),
                          frames=int(req.get("frames", args.frames)), num_inference_steps=int(req.get("steps", 4)),
                          lcm_origin_steps=int(req.get("lcm_origin_steps", 50)))
                chunk = req.get("decode_frame_chunk")
                call = dict(prompt=prompt, fps=int(req.get("fps", 16)),
                            guidance_scale=float(req.get("guidance_scale", 7.5)),
                            decode_frame_chunk=None if chunk is None else int(chunk), **kw)
                seed = int(req.get("seed", 0))
                with lock:
                    if relay is not None:
                        relay.send({"op": "generate", "call": call, "seed": seed})
                    video = pipe(generator=torch.Generator(device=device).manual_seed(seed), **call)
                    frames_u8 = video_to_uint8(video)[0]
                    points.add((kw["frames"], kw["height"], kw["width"], kw["num_inference_steps"],
                                kw["lcm_origin_steps"]))
                name = f"{uuid.uuid4().hex[:12]}{ext}"
                path = save_video(frames_u8, os.path.join(args.output_dir, name), fps=int(req.get("save_fps", 8)))
                entry = {"path": path, "video_url": f"/videos/{name}", "prompt": prompt,
                         "latency_s": round(time.perf_counter() - t0, 3), "shape": list(frames_u8.shape)}
                gallery.append(entry)
                del gallery[:-50]  # bound the in-memory gallery
                self._json(200, entry)
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    server.relay = relay
    return server


if __name__ == "__main__":
    main()
