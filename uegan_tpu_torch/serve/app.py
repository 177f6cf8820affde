"""HTTP scoring and enhancement service, counterpart of uegan_tpu/serve/app.py.

The same stdlib ``http.server`` service, endpoints, JSON shapes, status
codes and flags as the JAX package's; the forwards are the port's, on the
card unless the caller asks for the CPU.  Concurrent requests are
micro-batched into shared device calls (``_MicroBatcher``).

Endpoints:
- ``GET  /``                 service info (JSON)
- ``POST /api/get_scores``   body = raw image bytes -> NIMA mean/std + the
                             full 10-bucket distribution
- ``POST /api/enhance``      body = raw image bytes -> enhanced PNG bytes

The generator is the default one (cd 32, ``Config``'s defaults: bfloat16,
the packed forward, ``--quantized_inference`` for the int8 one), from a
reference ``.pth`` (``--generator_ckpt``; its EMA copy of G where it keeps
one, ``Config.ema_eval``) or, without one, seeded as the
Tester seeds it.  An orbax directory is refused at startup with the
``orbax_to_pth.py`` command that exports it.  The forward is
``infer/packed.py:make_fast_eval``, built after the load, between the u8
normalize and quantize on the device, so 1-byte pixels cross each way.
``--keep_aspect`` enhances at native size (pad to the 64-px grid, crop
back; the strip executor for large photos), unbatched.  Device work runs
under ``torch.inference_mode()`` on every thread that does it.  On a card
TF32 is off for the server's life: the float32 NIMA forward needs it off
(``ops/conv.py:exact_f32``), and flags flipped by one thread would reach
another's forward mid-way.

Run:  python -m uegan_tpu_torch.serve.app --port 5000 [--nima_weights p.pth]
          [--generator_ckpt results/UEGAN-FiveK/models/UEGAN-FiveK_rahinge_92.pth]
          [--platform cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch
from PIL import Image

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.infer.native import enhance_native
from uegan_tpu_torch.infer.packed import make_fast_eval, served_generator
from uegan_tpu_torch.metrics.nima import init_nima, prepare_image_np
from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth, orbax_refusal
from uegan_tpu_torch.utils.device import resolve_device
from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8

PLATFORMS = {"": None, "cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


class _MicroBatcher:
    """Cross-request micro-batching of one forward (JAX's ``_MicroBatcher``).

    Each request enqueues its preprocessed array and blocks on a Future; one
    worker thread takes the first request, waits up to ``window_ms`` for
    followers (at most ``max_batch``), pads the group with zeros to the next
    power of two (so only O(log max_batch) shapes reach the device), makes
    ONE ``run_batch`` call under ``torch.inference_mode()`` and hands each
    request its row.  A failed call fails every request of its group; the
    worker goes on.  ``calls`` counts the calls made."""

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray],
                 window_ms: float = 2.0, max_batch: int = 16):
        self.run_batch = run_batch
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.calls = 0
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def submit(self, arr: np.ndarray):
        """Block until the batched result for ``arr`` is available."""
        fut: Future = Future()
        with self._lock:
            if self._worker is None:
                self._worker = threading.Thread(target=self._loop, daemon=True)
                self._worker.start()
        self._q.put((arr, fut))
        return fut.result()

    def close(self, timeout: float = 60.0) -> None:
        """End the worker after the requests already queued."""
        with self._lock:
            worker, self._worker = self._worker, None
            if worker is not None:
                self._q.put(None)
        if worker is not None:
            worker.join(timeout)

    def _loop(self) -> None:
        with torch.inference_mode():  # grad mode is per thread
            while True:
                first = self._q.get()  # block for the first request
                if first is None:
                    return
                group, stop = [first], False
                deadline = time.monotonic() + self.window_s
                while len(group) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is None:
                        stop = True
                        break
                    group.append(item)
                self._run(group)
                if stop:
                    return

    def _run(self, group: list) -> None:
        arrs = np.stack([g[0] for g in group])
        b = arrs.shape[0]
        bucket = 1
        while bucket < b:
            bucket *= 2
        if bucket > b:
            pad = np.zeros((bucket - b,) + arrs.shape[1:], arrs.dtype)
            arrs = np.concatenate([arrs, pad])
        try:
            out = np.asarray(self.run_batch(arrs))
            self.calls += 1
            for i, (_, fut) in enumerate(group):
                fut.set_result(out[i])
        except Exception as e:  # surface to every waiting request
            for _, fut in group:
                if not fut.done():
                    fut.set_exception(e)


class _Models:
    """The models behind the endpoints, built at their first request under
    one lock, on ``device`` (default: ``resolve_device()``)."""

    def __init__(self, nima_weights: str = "", generator_ckpt: str = "",
                 test_img_size: int = 512, quantized_inference: str = "",
                 nima_dtype: str = "float32", batch_window_ms: float = 2.0,
                 max_batch: int = 16, keep_aspect: bool = False, device=None):
        self._lock = threading.Lock()
        self.nima_weights = nima_weights
        self.generator_ckpt = generator_ckpt
        self.test_img_size = test_img_size
        self.quantized_inference = quantized_inference
        self.nima_dtype = nima_dtype
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self.keep_aspect = keep_aspect
        self.device = resolve_device(device)
        self._nima = None
        self._enhance_fn = None
        self._nima_batcher: Optional[_MicroBatcher] = None
        self._enhance_batcher: Optional[_MicroBatcher] = None
        # fail at startup on a checkpoint the port cannot serve, not on the
        # first request (and never serve the seeded weights for a bad path)
        if generator_ckpt:
            if os.path.isdir(generator_ckpt):
                name = os.path.basename(os.path.normpath(generator_ckpt))
                raise NotImplementedError(f"{orbax_refusal(generator_ckpt, 'OUT_DIR')}, then "
                                          f"serve --generator_ckpt OUT_DIR/{name}.pth")
            if not (generator_ckpt.endswith(".pth") and os.path.isfile(generator_ckpt)):
                raise FileNotFoundError(f"generator_ckpt {generator_ckpt!r} is not a .pth file")
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    def nima_score(self, image: Image.Image):
        with self._lock:
            if self._nima is None:
                self._nima = init_nima(self.nima_weights, compute_dtype=self.nima_dtype,
                                       device=self.device)
                self._nima_batcher = _MicroBatcher(
                    lambda arrs: self._nima(torch.from_numpy(arrs).to(self.device)).cpu().numpy(),
                    self.batch_window_ms, self.max_batch)
        probs = self._nima_batcher.submit(prepare_image_np(image))
        buckets = np.arange(1, 11, dtype=np.float64)
        mean = float((probs * buckets).sum())
        std = float(np.sqrt((probs * (buckets - mean) ** 2).sum()))
        return {
            "mean_score": round(mean, 6),
            "std_score": round(std, 6),
            "scores": [round(float(s), 6) for s in probs],
        }

    def _build_enhancer(self) -> None:
        cfg = Config(quantized_inference=self.quantized_inference).validate()
        # the EMA copy where the file keeps one (Config.ema_eval), as JAX
        # serves; without a file the Tester's seeded weights, as JAX serves
        # its PRNGKey(0) init
        sd = (generator_state(load_pth(self.generator_ckpt), ema=cfg.ema_eval)
              if self.generator_ckpt else None)
        g = served_generator(cfg, sd, self.device).eval()
        # after the load: the packed (and int8) kernels are made from the
        # served weights; int8 calibrates on JAX's seeded batch, as JAX does
        with torch.inference_mode():
            self._enhance_fn = make_fast_eval(g, cfg)
        self._enhance_batcher = _MicroBatcher(lambda arrs: self._run_u8(arrs),
                                              self.batch_window_ms, self.max_batch)

    def _run_u8(self, arrs: np.ndarray) -> np.ndarray:
        """uint8 NHWC batch -> enhanced uint8 NHWC, normalized and quantized
        on the device; called under inference mode."""
        # a decoded image's array is read-only, which torch.from_numpy warns of
        arrs = np.require(arrs, requirements=("C", "W"))
        x = normalize_u8(torch.from_numpy(arrs).to(self.device))
        return quantize_u8(self._enhance_fn(x)).cpu().numpy()

    def enhance(self, image: Image.Image) -> bytes:
        with self._lock:
            if self._enhance_fn is None:
                self._build_enhancer()
        if self.keep_aspect:
            arr = np.asarray(image.convert("RGB"))[None]  # native uint8 NHWC
            with torch.inference_mode():
                out_u8 = enhance_native(self._run_u8, arr)[0]
        else:
            s = self.test_img_size
            arr = np.asarray(image.convert("RGB").resize((s, s), Image.BILINEAR))  # uint8
            out_u8 = self._enhance_batcher.submit(arr)
        buf = io.BytesIO()
        Image.fromarray(out_u8).save(buf, "PNG")
        return buf.getvalue()

    def close(self) -> None:
        for batcher in (self._nima_batcher, self._enhance_batcher):
            if batcher is not None:
                batcher.close()


class _Server(ThreadingHTTPServer):
    models: _Models
    # the listen backlog: at the stdlib's 5, a burst of clients connecting
    # at once is reset before a handler thread takes them
    request_queue_size = 128

    def server_close(self) -> None:
        super().server_close()
        self.models.close()


def create_server(host: str = "0.0.0.0", port: int = 5000, **model_kw) -> ThreadingHTTPServer:
    models = _Models(**model_kw)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/info"):
                self._json(200, {
                    "service": "uegan_tpu_torch",
                    "endpoints": ["/api/get_scores", "/api/enhance"],
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/api/get_scores", "/api/enhance"):
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                image = Image.open(io.BytesIO(data))
            except Exception as e:  # bad or absent image
                self._json(400, {"error": f"invalid image: {e}"})
                return
            try:
                if self.path == "/api/get_scores":
                    self._json(200, models.nima_score(image))
                else:
                    png = models.enhance(image)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
            except Exception as e:
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet
            pass

    srv = _Server((host, port), Handler)
    srv.models = models  # observability: batcher call counts, lazy handles
    return srv


def run_server(host="0.0.0.0", port=5000, **model_kw) -> None:
    srv = create_server(host, port, **model_kw)
    print(f"uegan_tpu_torch serving on {host}:{port} ({srv.models.device})")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--nima_weights", default="")
    p.add_argument("--generator_ckpt", default="", help="a reference .pth")
    p.add_argument("--test_img_size", type=int, default=512)
    p.add_argument("--quantized_inference", default="",
                   help="'', 'int8' or 'int8_pallas': the int8 enhancement path")
    p.add_argument("--nima_dtype", default="float32", help="float32 or bfloat16")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="micro-batching window: concurrent requests within it "
                        "share one device call (0 disables waiting)")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--keep_aspect", action="store_true",
                   help="enhance at native resolution (pad to the 64-px grid, crop "
                        "back) instead of the square test_img_size resize; "
                        "requests run unbatched")
    p.add_argument("--platform", default="",
                   help="'' (UEGAN_TORCH_DEVICE, default cuda), cpu, or gpu/cuda")
    a = p.parse_args(argv)
    if a.platform not in PLATFORMS:
        raise ValueError(f"--platform {a.platform!r}: one of {sorted(PLATFORMS)}")
    run_server(a.host, a.port, nima_weights=a.nima_weights,
               generator_ckpt=a.generator_ckpt, test_img_size=a.test_img_size,
               quantized_inference=a.quantized_inference,
               nima_dtype=a.nima_dtype, batch_window_ms=a.batch_window_ms,
               max_batch=a.max_batch, keep_aspect=a.keep_aspect,
               device=PLATFORMS[a.platform])


if __name__ == "__main__":
    main()
