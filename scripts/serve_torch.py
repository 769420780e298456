#!/usr/bin/env python
"""HTTP serving endpoint for the PyTorch port (``gavit_tpu_torch``).

Stdlib-only HTTP server wrapping :class:`gavit_tpu_torch.serving.Predictor`
(bucketed batches, device-resident weights, the Hopper kernels on CUDA):

    python scripts/serve_torch.py --config configs/vit_b16_graph2.yaml \
        [--checkpoint CKPT_DIR | --weights params.npz] \
        [--precision bf16|fp32|int8] [--tome-r R] [--coalesce-ms MS] \
        [--max-queue-rows N] [--max-body-mb MB] [--device cuda] \
        [--host 127.0.0.1] [--port 8476] [--no-warmup] [--set key=value]
    python scripts/serve_torch.py --artifact ARTIFACT_DIR [--device cuda] ...

``--artifact`` serves an artifact of ``scripts/export_serving_torch.py``
(``serving.py::ExportedPredictor``: the exported programs and their
weights, no model code); exactly one of ``--config`` and ``--artifact`` is
given, and the choices baked at export (``--checkpoint``, ``--weights``,
``--precision``, ``--tome-r``, ``--set``) cannot be combined with it.
On CUDA the Predictor serves each bucket from a CUDA graph captured at
warm-up (``--no-warmup``: at the bucket's first request).

``--checkpoint`` serves a checkpoint directory of ``scripts/train_torch.py``
(``best_model`` or ``checkpoint_epoch_*``); ``--weights`` an ``.npz`` whose
keys are the '/'-joined Flax parameter paths of the JAX model; with
neither the weights are random, from a seed. ``--precision int8`` serves
static PTQ: a QAT checkpoint (``--set training.qat=true`` at training)
under the scales it trained with, any other calibrated at warm-up on noise
images. ``--tome-r`` merges R token pairs after every block (composes with
int8). ``--coalesce-ms`` micro-batches concurrent requests
(``serving.py::MicroBatcher``), shedding load past ``--max-queue-rows``
pending rows with 503 and Retry-After; ``--max-body-mb`` refuses larger
bodies with 413. SIGTERM (or Ctrl-C) stops accepting, flushes every
accepted request and logs ``shutdown complete``. A MoE config
(``configs/examples/vit_b16_moe.yaml``) serves its small buckets on the
dense engine and its large ones on the grouped one; a config's ``mesh`` is
read and not used: the port runs on one card.

Endpoints (same bodies as ``scripts/serve.py``):
  GET  /healthz   → {"status": "ok", "model": ..., "image_size": ...}
  GET  /stats     → serve-lifetime latency percentiles (and the
                    micro-batcher's under "microbatch")
  GET  /metrics   → the same counters in Prometheus text exposition
  POST /predict   → body: PNG/JPEG bytes, or a JSON list-of-lists uint8
                    image [S,S,3] / batch [N,S,S,3]
                    response: {"probabilities", "labels", "disease_names"}
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import signal
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

logger = logging.getLogger("serve_torch")


class GavitHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a deep accept backlog (the stdlib's 5 resets
    connections under a burst of concurrent clients)."""

    request_queue_size = 128


def metrics_text(predictor, batcher=None) -> str:
    """``GET /metrics``: the counters of ``/stats`` in Prometheus text
    exposition, under the names and kinds ``scripts/serve.py`` emits."""
    lines = []

    def emit(name, kind, value, help_=""):
        if help_:
            lines.append(f"# HELP gavit_{name} {help_}")
        lines.append(f"# TYPE gavit_{name} {kind}")
        lines.append(f"gavit_{name} {value}")

    lat = predictor.latency_stats()
    emit("requests_total", "counter", lat.get("count", 0),
         "predict calls served (lifetime)")
    for q in ("p50", "p95", "p99", "mean"):
        if f"{q}_ms" in lat:
            emit(f"latency_{q}_ms", "gauge", lat[f"{q}_ms"],
                 f"{q} request latency over the sliding window")
    if batcher is not None:
        mb = batcher.stats()
        emit("microbatch_flushes_total", "counter", mb.get("flushes", 0),
             "device flushes (lifetime)")
        emit("microbatch_rows_total", "counter", mb.get("rows", 0),
             "rows flushed (lifetime)")
        if "mean_batch" in mb:
            emit("microbatch_mean_batch", "gauge", mb["mean_batch"])
            emit("microbatch_coalesced_frac", "gauge", mb["coalesced_frac"])
        emit("microbatch_pending_rows", "gauge", mb.get("pending_rows", 0),
             "rows queued + in-flight (backpressure signal)")
        emit("microbatch_rejected_total", "counter", mb.get("rejected", 0),
             "submissions shed with 503 at the admission bound")
    return "\n".join(lines) + "\n"


def build_handler(predictor, image_size: int, model_desc: str,
                  batcher=None, max_body_bytes: int = 128 << 20):
    from gavit_tpu_torch.serving import QueueFull

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict, headers: dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_desc,
                                 "image_size": image_size})
            elif self.path == "/stats":
                stats = predictor.latency_stats() or {"count": 0}
                if batcher is not None:
                    stats["microbatch"] = batcher.stats()
                self._send(200, stats)
            elif self.path == "/metrics":
                body = metrics_text(predictor, batcher).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body_bytes:
                    # refused before reading: the body is never buffered
                    self.close_connection = True
                    self._send(413, {
                        "error": f"request body {length} bytes exceeds "
                                 f"limit {max_body_bytes} (--max-body-mb)"})
                    return
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    arr = np.asarray(json.loads(raw), np.uint8)
                else:  # image bytes
                    from PIL import Image

                    with Image.open(io.BytesIO(raw)) as img:
                        img = img.convert("RGB")
                        if img.size != (image_size, image_size):
                            img = img.resize((image_size, image_size),
                                             Image.BILINEAR)
                        arr = np.asarray(img, np.uint8)
                if batcher is not None:
                    probs = batcher.submit(arr)
                else:
                    probs = predictor.predict_proba(arr)
                self._send(200, {
                    "probabilities": probs.round(5).tolist(),
                    "labels": predictor.labels_from_probs(probs),
                    "disease_names": predictor.disease_names,
                })
            except QueueFull as e:
                # shed at admission; Retry-After ≈ one drain of the queue
                self._send(503, {"error": str(e)},
                           headers={"Retry-After": "1"})
            except Exception as e:  # client-facing error surface
                logger.exception("predict failed")
                self._send(400, {"error": str(e)})

    return Handler


def model_desc(config) -> str:
    m = config.model
    desc = m.name
    if m.moe.enabled:
        desc += f"+moe{m.moe.num_experts}x{len(m.moe_sites())}"
    return f"{desc}+graph{m.graph.num_blocks}" if m.graph.enabled else desc


def make_server(argv=None):
    """Parse the flags and build the predictor, the micro-batcher (or None)
    and the HTTP server, not yet serving: ``(server, batcher, desc)``."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="")
    p.add_argument("--artifact", default="",
                   help="serve an artifact of scripts/export_serving_torch.py "
                        "(the exported programs and weights; no model code, "
                        "no --config)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory of scripts/train_torch.py")
    p.add_argument("--weights", default="",
                   help="npz of '/'-joined Flax parameter paths (default: "
                        "random weights from a seed)")
    p.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32", "int8"])
    p.add_argument("--tome-r", type=int, default=0,
                   help="token merging: merge the R most similar token pairs "
                        "after every block (composes with --precision int8)")
    p.add_argument("--max-body-mb", type=int, default=128,
                   help="refuse request bodies above this size with 413")
    p.add_argument("--max-queue-rows", type=int, default=None,
                   help="micro-batcher admission bound: 503 + Retry-After "
                        "once queued and in-flight rows would pass it "
                        "(default 8 full batches; 0 disables)")
    p.add_argument("--coalesce-ms", type=float, default=None, metavar="MS",
                   help="micro-batch concurrent requests: a request waits up "
                        "to MS ms to ride a bigger device batch (0: only "
                        "what is already queued). Off when unset")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; with --artifact, the "
                        "artifact's own device type by default")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="Override a config value (dotted keys, YAML values)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if bool(args.artifact) == bool(args.config):
        p.error("exactly one of --config or --artifact is required")
    if args.checkpoint and args.weights:
        p.error("--checkpoint and --weights are exclusive")

    from gavit_tpu_torch.serving import (ExportedPredictor, MicroBatcher,
                                         Predictor)

    if args.artifact:
        # precision, ToMe and the weights were baked at export: a flag that
        # would otherwise be ignored is refused
        baked = [flag for flag, on in (
            ("--checkpoint", args.checkpoint), ("--weights", args.weights),
            ("--precision", args.precision != "bf16"),
            ("--tome-r", args.tome_r), ("--set", args.overrides)) if on]
        if baked:
            p.error(f"{' '.join(baked)} cannot combine with --artifact "
                    "(those choices are baked into the artifact at export)")
        predictor = ExportedPredictor(args.artifact, device=args.device)
        image_size = predictor.image_size
        desc = f"{predictor.manifest['model']} (exported artifact)"
    else:
        from gavit_tpu_torch.config import load_config, mesh_note

        config = load_config(args.config, args.overrides)
        note = mesh_note(config)
        if note:
            logger.info(note)
        predictor = Predictor(config, args.weights or None,
                              checkpoint_path=args.checkpoint or None,
                              precision=args.precision,
                              device=args.device or "cuda",
                              tome_r=args.tome_r)
        image_size = config.data.image_size
        desc = model_desc(config)
    if not args.no_warmup:
        predictor.warmup()
    batcher = None
    if args.coalesce_ms is not None:
        batcher = MicroBatcher(predictor, max_wait_ms=args.coalesce_ms,
                               max_queue_rows=args.max_queue_rows)
        logger.info(f"Micro-batching: wait {args.coalesce_ms} ms, max batch "
                    f"{batcher.max_batch}, admission bound "
                    f"{batcher.max_queue_rows} rows")
    server = GavitHTTPServer(
        (args.host, args.port),
        build_handler(predictor, image_size, desc, batcher,
                      max_body_bytes=args.max_body_mb << 20))
    logger.info(f"Serving {desc} on http://{args.host}:"
                f"{server.server_address[1]}")
    return server, batcher, desc


def main(argv=None):
    server, batcher, _ = make_server(argv)

    # SIGTERM (and Ctrl-C) take the graceful path: stop accepting, flush
    # every accepted request, then close
    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
        server.shutdown()
        if batcher is not None:
            batcher.close()
        server.server_close()
        logger.info("shutdown complete")


if __name__ == "__main__":
    main()
