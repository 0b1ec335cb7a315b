"""HTTP serving frontends for :class:`RecommendService` (a copy of
``matrix_factorization_tpu/serve/api.py`` on the port's service).

The reference serves with FastAPI/uvicorn (``project_template/app/api.py``).
fastapi is optional, so the default server is a dependency-free stdlib
``ThreadingHTTPServer`` with the same endpoints and JSON schemas:

* ``GET /health``       -> {status, index_type, n_items, has_model, ...}
* ``POST /recommend``   -> {results: [{item_id, score, reason}]}
  body: {query, user_id?, k<=50, candidate_k<=500, alpha, embedding_model?}

``create_fastapi_app`` builds the same service as a FastAPI app when the
package is installed (gated import).
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from matrix_factorization_tpu_torch.serve.service import RecommendService


def _validate_recommend_body(body: dict) -> dict:
    if "query" not in body or not str(body["query"]).strip():
        raise ValueError("'query' is required")
    out = {
        "query": str(body["query"]),
        "user_id": body.get("user_id"),
        "k": int(body.get("k", 10)),
        "candidate_k": int(body.get("candidate_k", 100)),
        "alpha": float(body.get("alpha", 0.5)),
        "embedding_model": body.get("embedding_model"),
    }
    if not (1 <= out["k"] <= 50):
        raise ValueError("k must be in [1, 50]")
    if not (1 <= out["candidate_k"] <= 500):
        raise ValueError("candidate_k must be in [1, 500]")
    if not (0.0 <= out["alpha"] <= 1.0):
        raise ValueError("alpha must be in [0, 1]")
    return out


def make_handler(service: RecommendService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj) -> None:
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/health"):
                self._send(200, service.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            path = self.path.rstrip("/")
            try:
                body = self._read_body()
            except json.JSONDecodeError as e:
                self._send(422, {"error": f"invalid JSON: {e}"})
                return
            try:
                if path == "/recommend":
                    req = _validate_recommend_body(body)
                    self._send(200, {"results": service.recommend(**req)})
                elif path == "/recommend_batch":
                    queries = body.get("queries")
                    if not isinstance(queries, list) or not queries:
                        raise ValueError("'queries' must be a non-empty list")
                    shared = {k: v for k, v in body.items() if k != "queries"}
                    results = [
                        service.recommend(
                            **_validate_recommend_body({**shared, "query": q})
                        )
                        for q in queries
                    ]
                    self._send(200, {"results": results})
                elif path == "/plan":
                    from matrix_factorization_tpu_torch.serve.planner import (
                        PlanRequest,
                        plan_meals,
                    )

                    allowed = set(PlanRequest.__dataclass_fields__)
                    bad = set(body) - allowed
                    if bad:
                        raise ValueError(f"unknown plan fields: {sorted(bad)}")
                    rows = plan_meals(service, PlanRequest(**body))
                    self._send(200, {"plan": rows})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except ValueError as e:
                self._send(422, {"error": str(e)})
            except Exception as e:  # soft failure, actionable message
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service: RecommendService, host: str = "127.0.0.1",
          port: int = 8000) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    return httpd


def create_fastapi_app(service: RecommendService):
    """FastAPI adapter (requires the optional fastapi package)."""
    try:
        from fastapi import FastAPI
        from pydantic import BaseModel, Field
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "fastapi is not installed; use the stdlib server "
            "(matrix_factorization_tpu_torch.serve.api.serve) instead"
        ) from e

    class RecommendRequest(BaseModel):
        query: str
        user_id: Optional[str] = None
        k: int = Field(10, ge=1, le=50)
        candidate_k: int = Field(100, ge=1, le=500)
        alpha: float = Field(0.5, ge=0.0, le=1.0)
        embedding_model: Optional[str] = None

    app = FastAPI()

    @app.get("/health")
    def health():
        return service.health()

    @app.post("/recommend")
    def recommend(req: RecommendRequest):
        return {"results": service.recommend(**req.dict())}

    return app


def main() -> None:
    p = argparse.ArgumentParser(description="Serve the recommend API")
    p.add_argument("--artifacts", type=str, default="workdir/artifacts")
    p.add_argument("--features", type=str, default="workdir/features")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="torch device of the model and the dense index "
                        "(default: cuda)")
    a = p.parse_args()
    service = RecommendService.from_artifacts(
        Path(a.artifacts),
        Path(a.features) if Path(a.features).exists() else None,
        device=a.device,
    )
    httpd = serve(service, a.host, a.port)
    print(f"serving on http://{a.host}:{a.port} (GET /health, POST /recommend)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
