"""HTTP verification service.

Port of ``provekit_tpu/server.py``, the counterpart of the reference's Go
verifier server (``recursive-verifier/cmd/server/main.go:19-120``):
``POST /api/v1/verify`` with a JSON body carrying the proof transcript in
hex, verified against the prepared scheme the server loaded; 200 on a valid
proof, 400 on a malformed request or a failing proof, 404 on any other
path.  The scheme verifies on the card unless ``--device cpu`` asks for the
CPU.

Run: ``python -m provekit_tpu_torch.server --scheme scheme.nps [--port 8080]``
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MAX_BODY = 2 << 30  # 2 GB, matching the reference server's body limit


def make_handler(scheme):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0:
                    raise ValueError(f"Content-Length {length}")
            except ValueError as e:
                self._reply(400, {"error": f"malformed request: {e}"})
                return
            if length > MAX_BODY:
                self._reply(400, {"error": "body too large"})
                return
            # the body is read on every path: closing the connection on
            # unread bytes resets it, and the client loses the reply
            body = self.rfile.read(length)
            if self.path != "/api/v1/verify":
                self._reply(404, {"error": "not found"})
                return
            try:
                doc = json.loads(body)
                transcript = bytes.fromhex(doc["transcript"])
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": f"malformed request: {e}"})
                return
            try:
                from .compiler.scheme import NoirProof
                scheme.verify(NoirProof(transcript=transcript))
            except Exception as e:
                self._reply(400, {"error": f"verification failed: {e}"})
                return
            self._reply(200, {"status": "verified"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(prog="provekit-tpu-torch-server")
    p.add_argument("--scheme", required=True, help=".nps scheme file")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="torch device to verify on (default: the card)")
    args = p.parse_args(argv)

    from .io import files
    scheme = files.read(args.scheme, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(scheme))
    print(f"verify server on http://{args.host}:{server.server_port}"
          f"/api/v1/verify", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
