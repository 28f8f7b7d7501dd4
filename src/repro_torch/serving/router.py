"""``Router``: one serving front door over several resident graphs.

A ``GraphSession`` serves one layout; an endpoint serves many (the social
graph, the road network, yesterday's snapshot). ``Router`` owns a table
of named ``GraphSession``s and routes every query by graph name, so that
callers hold one object with one lifecycle:

    router = Router(background=True, max_inflight=2)
    router.add_graph("social", social_edges)
    router.add_graph("roads", road_edges, weights=w)
    router.bfs("social", root)            # facades take the graph first
    h = router.submit("roads", "sssp", root)
    router.close()                        # closes every session

Each session records its ``layout_signature`` (the shape identity of its
layout), and each dispatcher's handle table keys on it, as does the
process-wide ``fixpoint_handle`` cache through the spec; queries never
share a batch across graphs (a batch is one SpMM over one adjacency), so
the router's work is routing, per-graph isolation and aggregate
observability, not cross-graph batching. ``Router.signatures()`` exposes
the mapping.

Threading: the routing table is under a lock (``add_graph`` /
``remove_graph`` race-free against lookups), each session keeps its own
submit and flush locking, and ``background=True`` is forwarded so that
every session runs its own flush thread. ``close()`` is idempotent and
closes every session; a closed router raises the same typed
``SessionClosed`` as a closed session, and an unknown graph name raises
the typed ``UnknownGraph``.

``device`` is one of the session defaults: None means the card (every
``add_graph`` raises when there is none), as for every entry point of the
port.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..core.options import EngineConfig
from .dispatch import QueryResult
from .session import GraphLike, GraphSession, QueryHandle, SessionClosed


class UnknownGraph(KeyError):
    """Typed routing error: no resident graph under that name."""

    def __init__(self, name: str, known: Tuple[str, ...]):
        super().__init__(
            f"unknown graph {name!r}; resident graphs: "
            f"{sorted(known) or '(none)'}")
        self.name = name


class Router:
    """Routes queries to the per-graph ``GraphSession``s it owns.

    The constructor's keywords are the defaults of every session the router
    builds (``config``, ``max_batch``, ``max_inflight``, ``max_pending``,
    ``on_full``, ``background``, ``flush_interval``, ``slimwork``,
    ``device``); ``add_graph`` takes per-graph overrides of any of them.
    """

    def __init__(self, *, config: Optional[EngineConfig] = None,
                 max_batch: int = 64, max_inflight: int = 1,
                 max_pending: Optional[int] = None, on_full: str = "raise",
                 background: bool = False, flush_interval: float = 0.002,
                 slimwork: bool = True, device=None):
        self._defaults = dict(
            config=config, max_batch=max_batch, max_inflight=max_inflight,
            max_pending=max_pending, on_full=on_full, background=background,
            flush_interval=flush_interval, slimwork=slimwork, device=device)
        self._sessions: Dict[str, GraphSession] = {}
        self._lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------- graph table

    def add_graph(self, name: str, graph: GraphLike, *,
                  weights=None, **overrides) -> GraphSession:
        """Build and register a session for ``graph`` under ``name``.

        The layout is built (or moved to the device) once, here;
        ``overrides`` replace any router-level session default for this
        graph only. A name already resident is an error: ``remove_graph``
        it first to replace it.
        """
        kwargs = {**self._defaults, **overrides}
        with self._lock:
            if self._closed:
                raise SessionClosed("router is closed; cannot add graphs")
            if name in self._sessions:
                raise ValueError(
                    f"graph {name!r} is already resident; remove_graph() "
                    f"first to replace it")
            # the build runs under the table lock: built outside it, two
            # add_graph(name) calls could both pass the duplicate check
            sess = GraphSession(graph, weights=weights, **kwargs)
            self._sessions[name] = sess
        return sess

    def remove_graph(self, name: str) -> None:
        """Close and drop one resident graph (drains its in-flight work)."""
        with self._lock:
            sess = self._sessions.pop(name, None)
        if sess is None:
            raise UnknownGraph(name, self.graphs())
        sess.close()

    def session(self, name: str) -> GraphSession:
        """The resident session of ``name`` (typed error when absent)."""
        with self._lock:
            if self._closed:
                raise SessionClosed("router is closed")
            try:
                return self._sessions[name]
            except KeyError:
                raise UnknownGraph(name,
                                   tuple(self._sessions)) from None

    def graphs(self) -> Tuple[str, ...]:
        """Resident graph names, sorted."""
        with self._lock:
            return tuple(sorted(self._sessions))

    def signatures(self) -> Dict[str, tuple]:
        """name -> ``layout_signature`` of its resident layout."""
        with self._lock:
            return {name: s.layout_signature
                    for name, s in self._sessions.items()}

    # ------------------------------------------------------------ routing

    def submit(self, graph: str, algorithm: str, root: Optional[int] = None,
               **kwargs) -> QueryHandle:
        """Enqueue one query on the named graph's session (see
        ``GraphSession.submit`` for the query keywords and typed errors)."""
        return self.session(graph).submit(algorithm, root, **kwargs)

    def bfs(self, graph: str, root: int, semiring: str = "tropical",
            **kwargs) -> QueryResult:
        return self.session(graph).bfs(root, semiring, **kwargs)

    def sssp(self, graph: str, roots, **kwargs):
        return self.session(graph).sssp(roots, **kwargs)

    def cc(self, graph: str, semiring: str = "selmax") -> QueryResult:
        return self.session(graph).cc(semiring)

    def pagerank(self, graph: str, **kwargs) -> QueryResult:
        return self.session(graph).pagerank(**kwargs)

    def betweenness(self, graph: str) -> QueryResult:
        return self.session(graph).betweenness()

    def khop(self, graph: str, root: int, k: int, **kwargs) -> QueryResult:
        return self.session(graph).khop(root, k, **kwargs)

    # ---------------------------------------------------------- lifecycle

    def flush(self) -> None:
        """Flush every resident session."""
        for name in self.graphs():
            with self._lock:
                sess = self._sessions.get(name)
            if sess is not None:
                sess.flush()

    def drain(self) -> None:
        """Flush and harvest every resident session."""
        for name in self.graphs():
            with self._lock:
                sess = self._sessions.get(name)
            if sess is not None:
                sess.drain()

    def stats(self) -> dict:
        """Per-graph stats and a cross-graph ``total`` block."""
        with self._lock:
            sessions = dict(self._sessions)
        per_graph = {name: s.stats() for name, s in sessions.items()}
        agg_keys = ("submitted", "completed", "timeouts", "shed",
                    "batches_dispatched", "columns_total", "columns_real",
                    "sweeps_total", "queue_depth", "inflight")
        total = {k: sum(st[k] for st in per_graph.values())
                 for k in agg_keys}
        total["graphs"] = len(per_graph)
        return {"graphs": per_graph, "total": total}

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Close every session (drains in-flight work); idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for sess in sessions:
            sess.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
