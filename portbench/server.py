"""The server's launcher: the port's HTTP server (``serve.api.make_server``)
over a RecContext built from the seeded inputs, on 127.0.0.1 at an
ephemeral port, with a span around each Engine method call.

The inputs are the benchmark's (datagen.py): the ratings, ordered by user,
handed to the port as its preprocessed frame (user, anime, rating, user_id,
anime_id), the vocabularies of the raw ids, the raw catalog frames and the
initial weights. The spans are the benchmark's own: each records the method,
its start and end on the host's monotonic clock and its arguments, so that a
request's Engine time can be told from its HTTP, JSON and queueing time.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import pandas as pd
import torch

from portbench import datagen

ENGINE_METHODS = ("similar_anime", "similar_users", "user_prefs", "user_recs", "model_recs",
                  "similar_anime_batch", "model_recs_batch", "similar_users_batch")


@dataclass
class Inputs:
    """What the run made from the seed, kept for the reference: each user's
    anime (rows ordered by user) and the raw catalog frame."""

    anime: np.ndarray          # [n_ratings] anime row of each rating, by user
    offsets: np.ndarray        # [n_users + 1]
    catalog: pd.DataFrame

    def watched(self, user_row: int) -> np.ndarray:
        return self.anime[self.offsets[user_row]:self.offsets[user_row + 1]]


@dataclass
class Spans:
    """Engine method calls: (method, start, end, args), thread-safe; each
    call is also a profiler annotation, which a traced window's idle gaps
    are named by."""

    records: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def wrap(self, name: str, method):
        def call(engine, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                # Names the host's time in a traced window (trace.py).
                with torch.profiler.record_function(f"portbench.engine.{name}"):
                    return method(engine, *args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.records.append((name, t0, t1, args))
        return call


def build_context(cfg: dict, seed: int, device, clock=None, retrieval_dtype=None):
    """(RecContext, Inputs) from the seed. ``retrieval_dtype`` overrides the
    configuration's (the control's bf16 tables)."""
    from anime_recommendations_tpu_torch.data.catalog import Catalog
    from anime_recommendations_tpu_torch.data.vocab import Vocab
    from anime_recommendations_tpu_torch.models.two_tower import TwoTower
    from anime_recommendations_tpu_torch.recommend.context import RecContext

    r = datagen.ratings(cfg, seed, device)
    users = r.users.to(torch.int32).cpu().numpy()
    anime = r.anime.to(torch.int32).cpu().numpy()
    rating = r.rating.cpu().numpy()
    del r
    vocab = Vocab(user_ids=datagen.user_ids(np.arange(cfg["n_users"])),
                  anime_ids=datagen.anime_ids(np.arange(cfg["n_anime"])))
    frame = pd.DataFrame({"user": users, "anime": anime, "rating": rating,
                          "user_id": vocab.user_ids[users], "anime_id": vocab.anime_ids[anime]})
    raw_catalog, synopses = datagen.catalog_frames(cfg, seed)
    catalog = Catalog.from_frames(raw_catalog, synopses)
    counts = np.bincount(users, minlength=cfg["n_users"])
    inputs = Inputs(anime=anime, offsets=np.concatenate([[0], np.cumsum(counts)]),
                    catalog=raw_catalog)
    if clock:
        clock.mark("data")
    w = datagen.weights(cfg, seed, device)
    model = TwoTower(cfg["n_users"], cfg["n_anime"], cfg["embedding_size"], device=device)
    with torch.no_grad():
        for k, v in w.items():
            getattr(model, k).copy_(v)
    del w
    ctx = RecContext.build(model.eval(), vocab, catalog, frame, device=device,
                           retrieval_dtype=retrieval_dtype or cfg["retrieval_dtype"])
    return ctx, inputs


class Server:
    """``with Server(ctx, spans) as srv``: the port's server on a thread,
    its Engine's methods wrapped in spans; shut down and joined on exit,
    and the Engine class given its methods back."""

    def __init__(self, ctx, spans: Spans):
        self.ctx, self.spans = ctx, spans

    def __enter__(self):
        from anime_recommendations_tpu_torch.serve import api

        self._saved = {m: getattr(api.Engine, m) for m in ENGINE_METHODS}
        for m, fn in self._saved.items():
            setattr(api.Engine, m, self.spans.wrap(m, fn))
        self.httpd = api.make_server(self.ctx, host="127.0.0.1", port=0)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        from anime_recommendations_tpu_torch.serve import api

        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(60)
        for m, fn in self._saved.items():
            setattr(api.Engine, m, fn)
        return False
