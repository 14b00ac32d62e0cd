"""HTTP client for :class:`~repro_torch.serve.server.QueryServer` (stdlib only).

Library use:

    from repro_torch.serve import QueryClient
    c = QueryClient("http://127.0.0.1:8123")
    out = c.query([{"kind": "aggregation", "score": "score_count"}])
    out["results"][0]["estimate"], out["request"]["fresh"]

Connection-refused errors are retried with backoff for ``connect_wait``
seconds (default 10) — a client launched alongside the server does not need
a sleep to win the startup race.

CLI (mirrors ``repro_torch.launch.query``'s spec flags; exits non-zero if
``--expect-fresh`` or ``--expect-workloads`` is violated, which the CI smoke
uses to assert that a warm-store repeat request costs zero target-DNN
invocations and that a multi-workload server mounted everything):

    PYTHONPATH=src python -m repro_torch.serve.client --url http://127.0.0.1:8123 \\
        --wait-ready 60 --workload video \\
        --spec '{"kind": "aggregation", "score": "score_count", "err": 0.1}' \\
        --expect-fresh 0
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from repro_torch.obs import parse_prometheus_text, series_key


class ServerError(RuntimeError):
    """Non-2xx response from the query server (message = server's error).
    ``status`` carries the HTTP status code, so callers (the load
    generator's error-kind split) can tell a 4xx rejection from a 5xx
    server fault without string matching."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class ConnectRetriesExhausted(OSError):
    """Connection kept being refused for the whole ``connect_wait`` window.

    An ``OSError`` so existing ``except OSError`` connection handling (e.g.
    :meth:`QueryClient.healthy`) keeps working; the message carries the
    total time spent waiting and the attempt count, so a failed startup
    race is distinguishable from a server that was never there.
    """

    def __init__(self, url: str, waited_s: float, attempts: int,
                 cause: Exception):
        super().__init__(
            f"{url}: connection refused after {attempts} attempts over "
            f"{waited_s:.2f}s of backoff; last error: {cause}")
        self.waited_s = waited_s
        self.attempts = attempts


def _is_conn_refused(e: urllib.error.URLError) -> bool:
    return isinstance(getattr(e, "reason", None), ConnectionRefusedError)


class QueryClient:
    def __init__(self, url: str, timeout: float = 600.0,
                 connect_wait: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = float(timeout)
        self.connect_wait = float(connect_wait)

    def _call(self, path: str, payload: Optional[Any] = None,
              method: Optional[str] = None,
              retry_refused: bool = True, raw: bool = False) -> Any:
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.url + path, data=data,
            headers={"Content-Type": "application/json"},
            method=method or ("POST" if data is not None else "GET"))
        started = time.monotonic()
        deadline = started + self.connect_wait
        backoff = 0.05
        attempts = 0
        while True:
            attempts += 1
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    body = resp.read().decode()
                    return body if raw else json.loads(body)
            except urllib.error.HTTPError as e:
                try:
                    detail = json.loads(e.read().decode()).get("error", str(e))
                except Exception:  # noqa: BLE001 - best-effort error detail
                    detail = str(e)
                raise ServerError(f"{path}: {detail}",
                                  status=e.code) from None
            except urllib.error.URLError as e:
                # the server may simply not have bound its port yet: retry
                # connection-refused with jittered exponential backoff (full
                # jitter, so a fleet of clients racing one startup does not
                # hammer the port in lockstep) instead of failing a race no
                # client can win deterministically
                if not (retry_refused and _is_conn_refused(e)):
                    raise
                sleep = backoff * random.uniform(0.5, 1.0)
                if time.monotonic() + sleep >= deadline:
                    raise ConnectRetriesExhausted(
                        self.url + path, time.monotonic() - started,
                        attempts, e) from None
                time.sleep(sleep)
                backoff = min(backoff * 2, 1.0)

    # -- api -----------------------------------------------------------------
    def query(self, specs: List[Any], budget: Optional[int] = None,
              workload: Optional[str] = None,
              priority: Optional[int] = None,
              deadline_ms: Optional[float] = None,
              trace_id: Optional[str] = None) -> Dict[str, Any]:
        """POST specs (dicts or ``QuerySpec`` s); returns the response JSON:
        ``results`` (per-spec rows), ``session``, and ``request`` totals
        (including the request's ``trace_id``).  ``workload`` routes the
        whole request to one mounted workload (specs may carry their own
        ``workload`` field instead); ``priority`` (0 = most urgent) and
        ``deadline_ms`` (relative to arrival) place the request in the
        server's scheduling order; ``trace_id`` names the request's trace
        (else the server generates one)."""
        raw = [s if isinstance(s, dict) else s.to_dict() for s in specs]
        body: Any = raw
        extras = {"budget": budget, "workload": workload,
                  "priority": priority, "deadline_ms": deadline_ms,
                  "trace_id": trace_id}
        extras = {k: v for k, v in extras.items() if v is not None}
        if extras:
            body = {"specs": raw, **extras}
        return self._call("/query", payload=body)

    def stats(self) -> Dict[str, Any]:
        return self._call("/stats")

    def metrics(self) -> str:
        """The raw ``/metrics`` Prometheus text exposition."""
        return self._call("/metrics", raw=True)

    def traces(self, trace_id: Optional[str] = None,
               fmt: Optional[str] = None,
               limit: Optional[int] = None) -> Dict[str, Any]:
        """``/debug/traces``: recent summaries, or one full trace by id
        (``fmt="chrome"`` for a chrome://tracing-loadable document)."""
        params = []
        if trace_id is not None:
            params.append(f"id={trace_id}")
        if fmt is not None:
            params.append(f"format={fmt}")
        if limit is not None:
            params.append(f"limit={int(limit)}")
        query = "?" + "&".join(params) if params else ""
        return self._call("/debug/traces" + query)

    def workloads(self) -> Dict[str, Any]:
        """What the server has mounted: ``{"default": ..., "workloads":
        [{"name", "default", "loaded", "records", ...}, ...]}``."""
        return self._call("/workloads")

    def healthy(self) -> bool:
        try:
            # single probe: wait_ready owns the polling cadence
            return bool(self._call("/healthz", retry_refused=False).get("ok"))
        except (ServerError, OSError):
            return False

    def wait_ready(self, timeout: float = 30.0, poll: float = 0.2) -> None:
        """Block until ``/healthz`` answers (server start + index build can
        take a while); raises ``TimeoutError`` otherwise."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.healthy():
                return
            time.sleep(poll)
        raise TimeoutError(f"{self.url} not ready after {timeout}s")

    def shutdown(self) -> None:
        self._call("/shutdown", payload={}, method="POST")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="post QuerySpecs to a running repro_torch.serve QueryServer")
    ap.add_argument("--url", required=True, help="server base url")
    ap.add_argument("--spec", action="append",
                    help="QuerySpec as JSON (repeatable)")
    ap.add_argument("--specs-file", default=None,
                    help="file holding a JSON list of QuerySpecs")
    ap.add_argument("--budget", type=int, default=None,
                    help="session budget for this request (never coalesced)")
    ap.add_argument("--workload", default=None,
                    help="mounted workload to route this request to "
                         "(default: the server's default workload)")
    ap.add_argument("--priority", type=int, default=None,
                    help="scheduling class for this request (0 = most "
                         "urgent; default: the server's default class)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="soft latency target in ms; orders same-class "
                         "requests earliest-deadline-first")
    ap.add_argument("--wait-ready", type=float, default=0.0,
                    help="poll /healthz for up to this many seconds first")
    ap.add_argument("--connect-wait", type=float, default=10.0,
                    help="retry connection-refused with backoff for up to "
                         "this many seconds (startup race, no sleep needed)")
    ap.add_argument("--stats", action="store_true", help="print /stats")
    ap.add_argument("--list-workloads", action="store_true",
                    help="print /workloads")
    ap.add_argument("--expect-workloads", default=None,
                    help="comma-separated workload names; exit non-zero "
                         "unless /workloads lists every one (CI assertion)")
    ap.add_argument("--shutdown", action="store_true",
                    help="stop the server (after any query)")
    ap.add_argument("--expect-fresh", type=int, default=None,
                    help="exit non-zero unless the request's fresh-label "
                         "total equals this (CI assertion)")
    ap.add_argument("--dump-trace", default=None, metavar="PATH",
                    help="after the query, fetch its trace from "
                         "/debug/traces and write it as a Chrome trace-"
                         "event JSON file (load in chrome://tracing)")
    ap.add_argument("--check-metrics", action="store_true",
                    help="scrape /metrics before and after the query; "
                         "exit non-zero unless the exposition parses and "
                         "the workload's oracle_fresh_total advanced by "
                         "exactly the request's fresh count (assumes no "
                         "concurrent traffic, as in the CI smoke)")
    args = ap.parse_args(argv)

    client = QueryClient(args.url, connect_wait=args.connect_wait)
    if args.wait_ready > 0:
        client.wait_ready(timeout=args.wait_ready)

    specs: List[dict] = []
    if args.specs_file:
        with open(args.specs_file) as f:
            specs.extend(json.load(f))
    for s in args.spec or []:
        specs.append(json.loads(s))

    if specs:
        before = parse_prometheus_text(client.metrics()) \
            if args.check_metrics else None
        out = client.query(specs, budget=args.budget, workload=args.workload,
                           priority=args.priority,
                           deadline_ms=args.deadline_ms)
        print(json.dumps(out, indent=2))
        if args.expect_fresh is not None:
            got = out["request"]["fresh"]
            if got != args.expect_fresh:
                print(f"expected {args.expect_fresh} fresh labels, got {got}",
                      file=sys.stderr)
                sys.exit(1)
        if args.check_metrics:
            after = parse_prometheus_text(client.metrics())
            if not after:
                print("/metrics exposition is empty or unparseable",
                      file=sys.stderr)
                sys.exit(1)
            key = series_key("oracle_fresh_total",
                             workload=out["request"]["workload"])
            delta = after.get(key, 0.0) - before.get(key, 0.0)
            fresh = out["request"]["fresh"]
            if int(delta) != fresh:
                print(f"{key} advanced by {int(delta)} but the request "
                      f"paid {fresh} fresh labels", file=sys.stderr)
                sys.exit(1)
            print(f"[client] /metrics ok: {len(after)} series, "
                  f"{key} +{int(delta)} == request fresh", file=sys.stderr)
        if args.dump_trace:
            trace_id = out["request"].get("trace_id")
            if not trace_id:
                print("no trace_id in the response (server observability "
                      "disabled?); cannot --dump-trace", file=sys.stderr)
                sys.exit(1)
            doc = client.traces(trace_id=trace_id, fmt="chrome")
            with open(args.dump_trace, "w") as f:
                json.dump(doc, f)
            print(f"[client] trace {trace_id} "
                  f"({len(doc.get('traceEvents', []))} spans) -> "
                  f"{args.dump_trace}", file=sys.stderr)
    elif args.expect_fresh is not None:
        ap.error("--expect-fresh needs --spec/--specs-file")
    elif args.check_metrics or args.dump_trace:
        ap.error("--check-metrics/--dump-trace need --spec/--specs-file")

    if args.list_workloads or args.expect_workloads:
        wls = client.workloads()
        if args.list_workloads:
            print(json.dumps(wls, indent=2))
        if args.expect_workloads:
            mounted = {w["name"] for w in wls["workloads"]}
            missing = [n for n in args.expect_workloads.split(",")
                       if n and n not in mounted]
            if missing:
                print(f"expected workloads {missing} not mounted "
                      f"(mounted: {sorted(mounted)})", file=sys.stderr)
                sys.exit(1)
    if args.stats:
        print(json.dumps(client.stats(), indent=2))
    if args.shutdown:
        client.shutdown()


if __name__ == "__main__":
    main()
