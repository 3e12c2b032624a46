"""HTTP frontend for the online serving engine (stdlib only).

Port of ``dfol_vqa_tpu/http_frontend.py``. ``ServingHTTPFrontend`` wraps a
``ServingEngine`` (``serve.py``) in a threaded HTTP server, so the
continuous batcher sees concurrent traffic: each connection gets a handler
thread, ``submit`` compiles and canonicalizes the request on that thread,
and the threads then wait on their futures while the dispatcher groups
same-spec requests into padded device batches.

Endpoints (JSON in and out):

  GET  /healthz      -> {"ok": true, "device": "cuda" | "cpu", "device_name": ...}
  GET  /stats        -> engine counters + latency percentiles
  POST /v1/answer    -> {"question": {...}, "objects"?: [[..]], "obj_mask"?: [..]}
                        -> {"answers": [...], "latency_ms", "batch_size"}
  POST /v1/answers   -> {"questions": [{...}, ...]} -> {"results": [...]}
  POST /v1/trace     -> {"question": {...}} -> hop-by-hop attention trace
                        (per-slot object attentions + decoded answer)

``objects``/``obj_mask`` are optional when the engine owns a FeatureSource
(then ``question["imageId"]`` is looked up). A bad request gets 400, an
unknown path 404, an overloaded engine (``EngineOverloaded``) 429 with
``"retryable": true``, an engine fault 500.

The daemon (the ``dfol-vqa-torch-serve`` console script):

    python -m dfol_vqa_tpu_torch.http_frontend [--cpu] [--tiny] --port 8787 \\
        [--ckpt DIR --ckpt-name best] [--artifact DIR] [--warmup]

serves the demo engine over the planted world, on the card unless
``--cpu`` is given, with random weights or an npz checkpoint, live or from
an exported artifact (``export.py``; its modules are read at first use, or
all before listening with ``--warmup``), and prints ``listening on
http://HOST:PORT`` once the port is bound (``--port 0`` binds a free one).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dfol_vqa_tpu_torch.serve import EngineOverloaded


def _latency_summary(lats) -> dict:
    xs = np.asarray(lats, dtype=np.float64)
    if xs.size == 0:
        return {"n": 0}
    return {
        "n": int(xs.size),
        "p50_ms": float(np.percentile(xs, 50)),
        "p90_ms": float(np.percentile(xs, 90)),
        "p99_ms": float(np.percentile(xs, 99)),
        "mean_ms": float(xs.mean()),
    }


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of more concurrent
    # connections overflows it, and each dropped connection attempt waits
    # for the client's SYN retransmit (8 clients: 63 against 1,737 requests/s
    # to a bare handler with a backlog of 128, on an 8-core Xeon host)
    request_queue_size = 128


class ServingHTTPFrontend:
    """Threaded HTTP server over a running ServingEngine.

    ``port=0`` binds an ephemeral port (read ``.port`` after construction).
    ``serve_forever`` runs on a daemon thread, so the caller owns the
    lifecycle; ``close()`` stops the server (the engine is not stopped: it
    may be shared)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no access log per request
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        self._reply(200, frontend.healthz())
                    elif self.path == "/stats":
                        self._reply(200, frontend.stats())
                    else:
                        self._reply(404, {"error": f"no such path: {self.path}"})
                except Exception as e:  # always answer; never drop the socket
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:  # json.JSONDecodeError is a ValueError
                    return self._reply(400, {"error": f"bad JSON: {e}"})
                try:
                    if self.path == "/v1/answer":
                        self._reply(200, frontend.answer(req))
                    elif self.path == "/v1/answers":
                        self._reply(200, frontend.answers(req))
                    elif self.path == "/v1/trace":
                        self._reply(200, frontend.trace(req))
                    else:
                        self._reply(404, {"error": f"no such path: {self.path}"})
                except EngineOverloaded as e:  # queue at max_pending: back off
                    self._reply(429, {"error": str(e), "retryable": True})
                except (KeyError, ValueError, TypeError, IndexError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # engine-side failure
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._server = _Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- handlers

    def healthz(self) -> dict:
        device = self.engine.device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        return {"ok": True, "device": device.type, "device_name": name}

    def stats(self) -> dict:
        s = self.engine.stats
        # snapshot under the engine's locks: the counters and latencies are
        # written by the completion pool, _pending by submitters and the
        # dispatcher
        with self.engine._stats_lock:
            out = {k: v for k, v in s.items() if k != "latencies_ms"}
            lats = list(s["latencies_ms"])
        with self.engine._cond:
            pending = sum(len(q) for q in self.engine._pending.values())
        out["latency"] = _latency_summary(lats)
        out["pending"] = pending
        return out

    @staticmethod
    def _parse_features(req: dict):
        """Inline features of an answer or trace request, or (None, None)."""
        objs = req.get("objects")
        mask = req.get("obj_mask")
        if objs is not None:
            if mask is None:
                raise ValueError("objects given without obj_mask")
            objs = np.asarray(objs, dtype=np.float32)
            mask = np.asarray(mask, dtype=np.float32)
        return objs, mask

    def _submit(self, req: dict):
        objs, mask = self._parse_features(req)
        return self.engine.submit(req["question"], objs, mask)

    @staticmethod
    def _result_json(r) -> dict:
        return {"answers": r.answers, "latency_ms": r.latency_ms, "batch_size": r.batch_size}

    def answer(self, req: dict) -> dict:
        return self._result_json(self._submit(req).result())

    def answers(self, req: dict) -> dict:
        futs = [self._submit({"question": q, **extra}) for q, extra in _per_question(req)]
        return {"results": [self._result_json(f.result()) for f in futs]}

    def trace(self, req: dict) -> dict:
        objs, mask = self._parse_features(req)
        return self.engine.trace(req["question"], objs, mask)

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def _per_question(req: dict):
    qs = req["questions"]
    objs = req.get("objects")
    masks = req.get("obj_mask")
    if objs is not None:
        if masks is None:
            raise ValueError("objects given without obj_mask")
        if len(objs) != len(qs) or len(masks) != len(qs):
            raise ValueError(f"objects/obj_mask length ({len(objs)}/{len(masks)}) must "
                             f"match questions ({len(qs)})")
    for i, q in enumerate(qs):
        extra = {}
        if objs is not None:
            extra = {"objects": objs[i], "obj_mask": masks[i]}
        yield q, extra


# -------------------------------------------------------------- daemon CLI


def warmup_questions(world) -> list:
    """One planted question of every family at 0-2 hops."""
    from dfol_vqa_tpu_torch.data.planted import ALL_FAMILIES

    qs = []
    for fi, fam in enumerate(ALL_FAMILIES):
        for ln in (0, 1, 2):
            qs.extend(world.generate_family(fam, 1, length=ln, seed=3 + 10 * fi + ln,
                                            id_prefix=f"w{fam}{ln}-"))
    return qs


def main(argv=None):
    """``dfol-vqa-torch-serve``: start the HTTP daemon on the demo engine
    (planted world, random weights from seed 0 or an npz checkpoint),
    live or from an exported artifact; runs until interrupted."""
    import argparse
    import time

    from dfol_vqa_tpu_torch.serve import build_demo_engine
    from dfol_vqa_tpu_torch.train import checkpoint

    ap = argparse.ArgumentParser(prog="dfol-vqa-torch-serve")
    ap.add_argument("--cpu", action="store_true", help="serve on the CPU (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="small demo dims")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787, help="0 binds a free port")
    ap.add_argument("--objects", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=10.0)
    ap.add_argument("--max-pending", type=int, default=256,
                    help="admission-control bound on queued requests; arrivals beyond it "
                         "get HTTP 429 (0 = unbounded)")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (export_path_base)")
    ap.add_argument("--ckpt-name", default="best")
    ap.add_argument("--artifact", default=None, help="exported serving set dir (export.py)")
    ap.add_argument("--warmup", action="store_true",
                    help="make every step before listening: with --artifact, read every "
                         "module of it; else run every step of a planted sample")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dfol-vqa-torch-serve: no CUDA device; pass --cpu to serve on the CPU")

    _, _, world, eng = build_demo_engine(
        tiny=args.tiny, objects=args.objects, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, max_pending=args.max_pending or None, device=device)
    front = None
    try:
        if args.ckpt:
            eng.params, step = checkpoint.load(args.ckpt, args.ckpt_name, eng.params)
            print(f"[dfol-vqa-torch-serve] loaded {args.ckpt_name} @ step {step}", flush=True)
        if args.artifact:
            from dfol_vqa_tpu_torch.export import load_serving_set

            eng._exported.update(load_serving_set(args.artifact, engine=eng))
            print(f"[dfol-vqa-torch-serve] loaded {len(eng._exported)} exported steps",
                  flush=True)
        if args.warmup and args.artifact:
            t0 = time.perf_counter()
            n = eng.read_executables()
            print(f"[dfol-vqa-torch-serve] warmup: read {n} modules in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        elif args.warmup:
            print(f"[dfol-vqa-torch-serve] warmup "
                  f"{eng.warmup(warmup_questions(world), traces=True)}", flush=True)
        front = ServingHTTPFrontend(eng, host=args.host, port=args.port)
        print(f"[dfol-vqa-torch-serve] device={eng.device.type} listening on "
              f"http://{front.host}:{front.port}", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if front is not None:
            front.close()
        eng.stop()


if __name__ == "__main__":
    main()
