"""ArbiterHTTPServer: the FederationArbiter's own HTTP surface.

A copy of ``karpenter_tpu/federation/server.py``, with no difference.

Rides the same stdlib ThreadingHTTPServer pattern as the operator surface
(``utils/httpserver.py``) — port-0 auto-assign for tests, quiet logging,
daemon serve thread. Routes mirror the client's route TEMPLATES exactly
(``client.ROUTES``): the template string is both the breaker key on the
client side and the dispatch key here, so the two can never drift apart
silently.

* ``POST /v1/summary`` — capacity summary intake (seq-monotonic).
* ``POST /v1/lease`` — placement lease request (idempotent per token).
* ``POST /v1/lease/confirm`` — the epoch+TTL fence check before a launch.
* ``GET  /v1/state`` — full arbiter state (members, leases, rebalance) for
  operators and the fleet harness.
* ``GET  /healthz`` — liveness, same contract as the operator surface.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .arbiter import FederationArbiter


class ArbiterHTTPServer:
    def __init__(
        self,
        arbiter: FederationArbiter,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self.arbiter = arbiter
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, payload) -> None:
                body = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                if not raw:
                    return {}
                try:
                    parsed = json.loads(raw)
                except json.JSONDecodeError:
                    return {}
                return parsed if isinstance(parsed, dict) else {}

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.partition("?")[0]
                if path == "/v1/state":
                    self._reply(200, outer.arbiter.state())
                elif path == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.partition("?")[0]
                body = self._body()
                if path == "/v1/summary":
                    self._reply(200, outer.arbiter.submit_summary(body))
                elif path == "/v1/lease":
                    if not body.get("token"):
                        self._reply(400, {"error": "missing token"})
                    else:
                        self._reply(200, outer.arbiter.request_lease(body))
                elif path == "/v1/lease/confirm":
                    self._reply(
                        200,
                        outer.arbiter.confirm_lease(
                            body.get("token", ""), body.get("epoch")
                        ),
                    )
                else:
                    self._reply(404, {"error": "not found"})

            def log_message(self, fmt, *args) -> None:  # quiet by default
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ArbiterHTTPServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
