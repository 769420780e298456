#!/usr/bin/env python
"""HTTP serving endpoint for the PyTorch port (``gavit_tpu_torch``).

Stdlib-only HTTP server wrapping :class:`gavit_tpu_torch.serving.Predictor`
(bucketed batches, device-resident weights, the Hopper kernels on CUDA):

    python scripts/serve_torch.py --config configs/vit_b16_graph2.yaml \
        [--weights params.npz] [--precision bf16|fp32] [--device cuda] \
        [--host 127.0.0.1] [--port 8476] [--no-warmup] [--set key=value]

``--weights`` is an ``.npz`` whose keys are the '/'-joined Flax parameter
paths of the JAX model; without it the weights are random, from a seed. A
MoE config (``configs/examples/vit_b16_moe.yaml``) serves its small
buckets on the dense engine and its large ones on the grouped one; a
config's ``mesh`` is read and not used: the port runs on one card.

Endpoints (same bodies as ``scripts/serve.py``):
  GET  /healthz   → {"status": "ok", "model": ..., "image_size": ...}
  GET  /stats     → serve-lifetime latency percentiles
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


def build_handler(predictor, image_size: int, model_desc: str,
                  max_body_bytes: int = 128 << 20):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_desc,
                                 "image_size": image_size})
            elif self.path == "/stats":
                self._send(200, predictor.latency_stats() or {"count": 0})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body_bytes:
                    self.close_connection = True
                    self._send(413, {"error": f"request body {length} bytes "
                                              f"exceeds {max_body_bytes}"})
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
                probs = predictor.predict_proba(arr)
                self._send(200, {
                    "probabilities": probs.round(5).tolist(),
                    "labels": predictor.labels_from_probs(probs),
                    "disease_names": predictor.disease_names,
                })
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


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--weights", default="",
                   help="npz of '/'-joined Flax parameter paths (default: "
                        "random weights from a seed)")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="Override a config value (dotted keys, YAML values)")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)

    from gavit_tpu_torch.config import load_config, mesh_note
    from gavit_tpu_torch.serving import Predictor

    config = load_config(args.config, args.overrides)
    note = mesh_note(config)
    if note:
        logger.info(note)
    predictor = Predictor(config, args.weights or None,
                          precision=args.precision, device=args.device)
    if not args.no_warmup:
        predictor.warmup()
    desc = model_desc(config)
    server = GavitHTTPServer(
        (args.host, args.port),
        build_handler(predictor, config.data.image_size, desc))
    logger.info(f"Serving {desc} on http://{args.host}:{args.port}")

    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
