"""Serving daemon: request-coalescing HTTP batch server around `Predictor`.

The same server as istvt_tpu/serve_daemon.py, kept as a framework-free
copy so that the port runs without importing the JAX package;
tests/test_torch_serve.py holds its code equal to the JAX package's.

  * `RequestBatcher` - a dispatcher thread that coalesces concurrent
    requests into one device batch (up to `max_batch` clips, lingering at
    most `max_wait_ms`); all device work stays on that one thread.
  * `ServeDaemon` - a stdlib ThreadingHTTPServer:
       POST /v1/predict   body = .npy bytes, (T,H,W,3) or (N,T,H,W,3);
                          float32 = already normalized, uint8 = raw
                          pixels, normalized with (x/255 - 0.5)/0.5
                          -> JSON {logits, probs, preds}
       GET  /healthz      -> {"ok": true}
       GET  /v1/stats     -> counters + latency/batch-occupancy stats

CLI: `python -m istvt_tpu_torch.cli.serve --int8`.
"""
from __future__ import annotations

import json
import io
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np


def normalize_uint8(clips: np.ndarray) -> np.ndarray:
    """Raw uint8 pixels -> the reference's model input domain."""
    return (clips.astype(np.float32) / 255.0 - 0.5) / 0.5


class _Pending:
    __slots__ = ("clips", "future", "t_enqueue")

    def __init__(self, clips: np.ndarray):
        self.clips = clips
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


class RequestBatcher:
    """Coalesce concurrent predict() calls into shared device batches.

    predict_fn: (N, ...) ndarray -> dict of (N,) arrays (Predictor.predict
    contract). All device work runs on the single dispatcher thread.
    """

    def __init__(self, predict_fn, max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_queue: int = 1024):
        self.predict_fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = int(max_queue)
        self._queue: deque[_Pending] = deque()
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._closed = False
        # stats (under _lock)
        self.n_requests = 0
        self.n_clips = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.batch_occupancy: Dict[int, int] = {}
        self._latencies: deque[float] = deque(maxlen=1024)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="istvt-batcher")
        self._thread.start()

    # -- client side ------------------------------------------------------
    def submit(self, clips: np.ndarray) -> Future:
        """Enqueue (N, ...) clips; future resolves to {'logits','probs',
        'preds'} arrays of length N."""
        if clips.ndim < 2 or clips.shape[0] == 0:
            raise ValueError(f"bad clips shape {clips.shape}")
        item = _Pending(clips)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            queued = sum(p.clips.shape[0] for p in self._queue)
            if queued + clips.shape[0] > self.max_queue:
                self.n_rejected += 1
                raise OverflowError("serving queue full")
            self._queue.append(item)
            self.n_requests += 1
            self.n_clips += clips.shape[0]
            self._wakeup.notify()
        return item.future

    def predict(self, clips: np.ndarray) -> Dict[str, np.ndarray]:
        return self.submit(clips).result()

    # -- dispatcher -------------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Block for the first request, then linger max_wait for more."""
        with self._lock:
            while not self._queue and not self._closed:
                self._wakeup.wait(timeout=0.2)
            if not self._queue:
                return []
            deadline = self._queue[0].t_enqueue + self.max_wait
            while True:
                have = sum(p.clips.shape[0] for p in self._queue)
                now = time.monotonic()
                if have >= self.max_batch or now >= deadline or self._closed:
                    break
                self._wakeup.wait(timeout=min(deadline - now, 0.05))
            taken, have = [], 0
            while self._queue:
                nxt = self._queue[0].clips.shape[0]
                if taken and have + nxt > self.max_batch:
                    break
                taken.append(self._queue.popleft())
                have += nxt
            return taken

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                with self._lock:
                    if self._closed and not self._queue:
                        return
                continue
            clips = (batch[0].clips if len(batch) == 1 else
                     np.concatenate([p.clips for p in batch]))
            try:
                out = self.predict_fn(clips)
            except BaseException as e:  # propagate to every waiter
                for p in batch:
                    p.future.set_exception(e)
                continue
            t_done = time.monotonic()
            with self._lock:
                self.n_batches += 1
                self.batch_occupancy[clips.shape[0]] = \
                    self.batch_occupancy.get(clips.shape[0], 0) + 1
                for p in batch:
                    self._latencies.append(t_done - p.t_enqueue)
            i = 0
            for p in batch:
                n = p.clips.shape[0]
                p.future.set_result({k: v[i:i + n] for k, v in out.items()})
                i += n

    # -- lifecycle / stats ------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Drain the queue, then stop the dispatcher."""
        with self._lock:
            self._closed = True
            self._wakeup.notify_all()
        self._thread.join(timeout=timeout)

    def stats(self) -> Dict:
        with self._lock:
            lats = sorted(self._latencies)
            occ = dict(sorted(self.batch_occupancy.items()))
            q = lambda f: (lats[min(int(f * len(lats)), len(lats) - 1)]
                           * 1e3 if lats else None)
            return {
                "requests": self.n_requests,
                "clips": self.n_clips,
                "batches": self.n_batches,
                "rejected": self.n_rejected,
                "mean_clips_per_batch": (self.n_clips / self.n_batches
                                         if self.n_batches else None),
                "batch_occupancy": occ,
                "latency_ms": {"p50": q(0.5), "p95": q(0.95), "p99": q(0.99)},
            }


class _Handler(BaseHTTPRequestHandler):
    daemon = None  # type: ServeDaemon
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if self.daemon.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True, "model": self.daemon.model_name})
        elif self.path == "/v1/stats":
            self._reply(200, self.daemon.batcher.stats())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/predict":
            return self._reply(404, {"error": f"no route {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(n)
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
        except Exception as e:
            return self._reply(400, {"error": f"bad .npy body: {e}"})
        expect = self.daemon.clip_shape  # (T, H, W, 3)
        if arr.shape[-len(expect):] != expect:
            return self._reply(400, {
                "error": f"clip shape {arr.shape} does not end with "
                         f"{expect}"})
        if arr.ndim == len(expect):
            arr = arr[None]
        if arr.ndim != len(expect) + 1:
            return self._reply(400, {"error": f"bad rank {arr.ndim}"})
        if arr.dtype == np.uint8:
            arr = normalize_uint8(arr)
        elif arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        try:
            out = self.daemon.batcher.predict(arr)
        except OverflowError:
            return self._reply(429, {"error": "serving queue full"})
        except Exception as e:
            return self._reply(500, {"error": repr(e)})
        self._reply(200, {
            "logits": [float(x) for x in out["logits"]],
            "probs": [float(x) for x in out["probs"]],
            "preds": [int(x) for x in out["preds"]],
        })


class ServeDaemon:
    """HTTP front end over a RequestBatcher.

    predictor: serve.Predictor (or anything with .predict).
    clip_shape: per-clip trailing shape, e.g. (6, 300, 300, 3).
    """

    def __init__(self, predictor, clip_shape: Sequence[int],
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 max_queue: int = 1024, verbose: bool = False):
        self.model_name = getattr(getattr(predictor, "model", None),
                                  "name", type(predictor).__name__)
        self.clip_shape = tuple(clip_shape)
        self.verbose = verbose
        self.batcher = RequestBatcher(predictor.predict,
                                      max_batch=max_batch,
                                      max_wait_ms=max_wait_ms,
                                      max_queue=max_queue)
        handler = type("BoundHandler", (_Handler,), {"daemon": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self):
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="istvt-http")
        self._serve_thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever(poll_interval=0.2)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
