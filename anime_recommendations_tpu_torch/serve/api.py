"""Query surface: in-process Engine + stdlib HTTP JSON API.

Counterpart of anime_recommendations_tpu/serve/api.py, with the same routes
and JSON:

    GET /health
    GET /similar_anime?name=...&k=10[&types=TV,Movie][&genres=a,b,c]
    GET /similar_users?user_id=...&k=10
    GET /user_prefs?user_id=...
    GET /user_recs?user_id=...&k=10
    GET /model_recs?user_id=...&k=10[&types=...]
    GET /similar_anime_batch?names=a|b|c&k=10
    GET /model_recs_batch?user_ids=1,2,3&k=10
    GET /similar_users_batch?user_ids=1,2,3&k=10[&faves=0]

Spans (utils/profiling.span, recorded while the recorder is on): each
request is the root ``serve.request`` (from do_GET's first line to the last
byte of its body written; attributes route and status), each Engine method
``engine.<method>`` under it.
"""

from __future__ import annotations

import functools
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import pandas as pd

from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.recommend import batch
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.recommend.model_recs import model_recs
from anime_recommendations_tpu_torch.recommend.similar_anime import similar_anime
from anime_recommendations_tpu_torch.recommend.similar_users import similar_users
from anime_recommendations_tpu_torch.recommend.user_prefs import user_prefs
from anime_recommendations_tpu_torch.recommend.user_recs import user_recs
from anime_recommendations_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def _records(frame: pd.DataFrame) -> list[dict]:
    return json.loads(frame.to_json(orient="records"))


def _spanned(method):
    """An Engine method under the span ``engine.<method>``."""
    name = f"engine.{method.__name__}"

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with span(name):
            return method(self, *args, **kwargs)

    return call


class Engine:
    """In-process query API over a built RecContext.

    The similar-users scan is the one sub-query two endpoints repeat per
    request (/similar_users and the first stage of /user_recs), so its
    results are LRU-cached per (user_id, k). The tables are immutable for
    the Engine's lifetime, so entries never go stale; ``cache_size=0``
    disables caching.

    On a card each scan is a replay of one of the context's scan graphs
    (ops/scan_graph.py), shared by the server's threads: its lock keeps one
    request's copies into a graph's buffers, the replay and the copies of
    its outputs apart from every other request's, and a capture apart from
    every other scan. Each request gets its own outputs and reads them to
    the host itself.
    """

    def __init__(self, ctx: RecContext, config: Config | None = None,
                 cache_size: int = 256):
        self.ctx = ctx
        self.cfg = config or Config()
        self._similar_users_cached = (
            functools.lru_cache(maxsize=cache_size)(self._similar_users_scan)
            if cache_size else self._similar_users_scan
        )

    def _similar_users_scan(self, user_id: int, k: int):
        frame, _, _ = similar_users(
            self.ctx, user_id, n_users=k,
            num_faves=self.cfg.users.num_faves,
            TV_only=self.cfg.users.TV_only,
        )
        return frame

    def _similar_users(self, user_id: int, k: int):
        """Cache at a shared depth so /similar_users and /user_recs hit the
        same entry for a user: both round k up to max(k, recs_n_sim_ID) and
        slice (top-k is a prefix of top-K)."""
        kc = max(k, self.cfg.users.recs_n_sim_ID)
        frame = self._similar_users_cached(user_id, kc)
        return frame.head(k) if k < kc else frame

    def cache_info(self) -> dict:
        """The similar-users LRU's counts (hits, misses, ...; none with
        ``cache_size=0``) and, under ``id_index``, the context's id indexes'
        builds and ids translated (RecContext.id_index_report)."""
        info = getattr(self._similar_users_cached, "cache_info", None)
        out = {} if info is None else info()._asdict()
        out["id_index"] = self.ctx.id_index_report()
        return out

    @_spanned
    def similar_anime(self, name: str, k: int = 10, types=None, genres=None):
        frame, _, _ = similar_anime(self.ctx, name, count=k, types=types,
                                    genres=genres)
        return _records(frame)

    @_spanned
    def similar_users(self, user_id: int, k: int = 10):
        return _records(self._similar_users(user_id, k))

    @_spanned
    def user_prefs(self, user_id: int):
        prefs = user_prefs(
            self.ctx, user_id, percentile=self.cfg.users.favorite_percentile
        )
        return {
            "user_id": user_id,
            "favorites": _records(prefs.merged),
            "genre_frequencies": prefs.genre_frequencies,
            "source_frequencies": prefs.source_frequencies,
        }

    @_spanned
    def user_recs(self, user_id: int, k: int = 10):
        sim = self._similar_users(user_id, self.cfg.users.recs_n_sim_ID)
        frame, _ = user_recs(
            self.ctx, user_id, sim["similar_users"].to_numpy(), n=k,
            percentile=self.cfg.users.favorite_percentile,
        )
        return _records(frame)

    @_spanned
    def model_recs(self, user_id: int, k: int = 10, types=None, genres=None):
        frame, _ = model_recs(self.ctx, user_id, n_recs=k, types=types,
                              genres=genres)
        return _records(frame)

    @_spanned
    def similar_anime_batch(self, names: list, k: int = 10, types=None,
                            genres=None):
        return batch.similar_anime_batch(self.ctx, names, count=k, types=types,
                                         genres=genres)

    @_spanned
    def model_recs_batch(self, user_ids: list[int], k: int = 10, types=None,
                         genres=None):
        return batch.model_recs_batch(self.ctx, user_ids, n_recs=k, types=types,
                                      genres=genres)

    @_spanned
    def similar_users_batch(self, user_ids: list[int], k: int = 10,
                            include_faves: bool = True):
        return batch.similar_users_batch(
            self.ctx, user_ids, n_users=k,
            num_faves=self.cfg.users.num_faves,
            TV_only=self.cfg.users.TV_only,
            include_faves=include_faves,
        )


def _make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            logger.debug(fmt, *args)

        def do_GET(self):  # noqa: N802 (stdlib API)
            with span("serve.request") as s:
                parsed = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                try:
                    payload = self._route(parsed.path, q)
                    body = json.dumps(payload).encode()
                    status = 200
                except KeyError as e:
                    body = json.dumps({"error": f"not found: {e}"}).encode()
                    status = 404
                except (ValueError, TypeError) as e:
                    body = json.dumps({"error": str(e)}).encode()
                    status = 400
                except Exception as e:  # the server keeps serving other requests
                    logger.exception("request failed")
                    body = json.dumps({"error": str(e)}).encode()
                    status = 500
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                s.annotate(route=parsed.path, status=status)

        def _route(self, path: str, q: dict):
            def listy(key):
                return q[key].split(",") if key in q else None

            if path == "/health":
                return {
                    "status": "ok",
                    "n_users": engine.ctx.vocab.n_users,
                    "n_anime": engine.ctx.vocab.n_anime,
                }
            if path == "/similar_anime":
                return engine.similar_anime(
                    q["name"], k=int(q.get("k", 10)),
                    types=listy("types"), genres=listy("genres"),
                )
            if path == "/similar_users":
                return engine.similar_users(int(q["user_id"]), k=int(q.get("k", 10)))
            if path == "/user_prefs":
                return engine.user_prefs(int(q["user_id"]))
            if path == "/user_recs":
                return engine.user_recs(int(q["user_id"]), k=int(q.get("k", 10)))
            if path == "/model_recs":
                return engine.model_recs(
                    int(q["user_id"]), k=int(q.get("k", 10)),
                    types=listy("types"), genres=listy("genres"),
                )
            if path == "/similar_anime_batch":
                return engine.similar_anime_batch(
                    q["names"].split("|"), k=int(q.get("k", 10)),
                    types=listy("types"), genres=listy("genres"),
                )
            if path == "/model_recs_batch":
                return engine.model_recs_batch(
                    [int(u) for u in q["user_ids"].split(",")],
                    k=int(q.get("k", 10)),
                    types=listy("types"), genres=listy("genres"),
                )
            if path == "/similar_users_batch":
                return engine.similar_users_batch(
                    [int(u) for u in q["user_ids"].split(",")],
                    k=int(q.get("k", 10)),
                    include_faves=q.get("faves", "1") not in ("0", "false"),
                )
            raise KeyError(path)

    return Handler


def make_server(ctx: RecContext, config: Config | None = None,
                host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
    engine = Engine(ctx, config)
    return ThreadingHTTPServer((host, port), _make_handler(engine))


def serve_http(ctx: RecContext, config: Config | None = None,
               host: str = "127.0.0.1", port: int = 8080) -> None:
    server = make_server(ctx, config, host, port)
    logger.info("serving on http://%s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
