"""HTTP/JSON front of the persistent analysis service (`python -m
mythril_tpu_torch serve`).

Stdlib-only (http.server): the service targets the same no-egress
container the rest of the toolchain runs in, so no web framework.

Endpoints:
  POST /v1/jobs                submit {"code": "0x..."} -> 202 {job_id}
                               (429 queue full, 503 draining, 400 junk)
  GET  /v1/jobs/<id>           job status (+ report when terminal)
  GET  /v1/jobs/<id>/report    long-poll until terminal (?wait_s=30)
  GET  /healthz                liveness + draining flag
  GET  /stats                  queue depth, lane occupancy, wave rate,
                               warm-cache counters, degradation counts
                               (schema_version-pinned)
  GET  /metrics                the whole metrics registry in Prometheus
                               text exposition format (observe/)
  GET  /trace                  recent flight-recorder spans as JSON
                               (?n=512; ?format=perfetto for a
                               Perfetto-loadable trace document)
  POST /v1/drain               begin the graceful drain (also SIGTERM)

Drain semantics (SIGTERM or /v1/drain): new submissions get 503, the
in-flight wave and in-flight host analyses finish, every other
accepted job is checkpointed to a replayable npz
(laser/batch/checkpoint.py) and reported as `checkpointed` — accepted
work is never dropped. The signal handler chains to whatever handler
was installed before it (support/resilience.py keeps its own handlers
restore-and-chain-safe for exactly this embedding).

The port's copy of the JAX package's service/server.py: the same
routes, status codes and payloads over the port's engine."""

from __future__ import annotations

import json
import logging
import re
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
from mythril_tpu_torch.service.jobs import Job, QueueRefusal

log = logging.getLogger(__name__)

_JOB_PATH = re.compile(r"^/v1/jobs/([0-9a-f]{12})(/report|/trace)?$")

#: QueueRefusal.reason -> HTTP status
_REFUSAL_STATUS = {"full": 429, "draining": 503}

#: Retry-After hints (seconds) riding every backpressure answer: a
#: full queue clears as soon as the next wave settles jobs (come back
#: quickly); a draining replica is going away (find another one — the
#: fleet front reads exactly this to pace its shed/retry policy)
_RETRY_AFTER = {"full": 1, "draining": 5}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # the engine rides on the server object (ThreadingHTTPServer
    # instantiates a handler per request)
    @property
    def engine(self) -> AnalysisEngine:
        return self.server.engine  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # route through logging, quietly
        log.debug("http: " + fmt, *args)

    def _reply(
        self, status: int, payload: Dict,
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, status: int, body: str, content_type: str) -> None:
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _query(self) -> Tuple[str, Dict[str, str]]:
        path, _, query = self.path.partition("?")
        params = {}
        for pair in query.split("&"):
            if "=" in pair:
                key, _, value = pair.partition("=")
                params[key] = value
        return path, params

    # -- GET -----------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path, params = self._query()
        if path == "/healthz":
            # the readiness/liveness split: the payload always carries
            # the full health machine (liveness = the process answered
            # at all); `?ready=1` turns the STATUS CODE into the
            # readiness probe a fleet front / load balancer keys on —
            # 503 while warming, compiling, draining, or redlined,
            # with the enumerated reason in the body
            payload = self.engine.health.healthz_payload()
            payload["draining"] = self.engine.draining
            payload["uptime_s"] = round(
                time.monotonic() - self.engine.started_t, 3
            )
            status = 200
            headers = None
            if params.get("ready") and not payload["ready"]:
                status = 503
                headers = {"Retry-After": str(
                    _RETRY_AFTER["draining"]
                    if payload["draining"]
                    else _RETRY_AFTER["full"]
                )}
            self._reply(status, payload, headers=headers)
            return
        if path == "/v1/frontier/export":
            # the cross-host rebalance handoff: a DRAINING replica's
            # unfinished jobs, each with its live exploration frontier
            # (explore.py export_frontier shape) so a survivor seeded
            # with it CONTINUES this replica's work. Guarded: a healthy
            # replica refuses (its jobs are not up for grabs) unless
            # the caller forces the export (tests, operator tooling).
            if not (self.engine.draining or params.get("force")):
                self._reply(
                    409,
                    {"error": "replica is not draining "
                     "(pass ?force=1 to export anyway)"},
                )
                return
            self._reply(200, self.engine.export_frontiers())
            return
        if path == "/stats":
            self._reply(200, self.engine.stats())
            return
        if path == "/metrics":
            # the whole registry, Prometheus text exposition (0.0.4)
            from mythril_tpu_torch import observe

            self._reply_text(
                200,
                observe.registry().prometheus_text(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            return
        if path == "/trace":
            from mythril_tpu_torch import observe
            from mythril_tpu_torch.observe.spans import flight_recorder

            try:
                n = min(int(params.get("n", 512)), 8192)
            except ValueError:
                n = 512
            spans = flight_recorder().tail(n)
            if params.get("format") == "perfetto":
                self._reply(200, observe.to_perfetto(spans))
                return
            self._reply(
                200,
                {
                    "schema_version": observe.SCHEMA_VERSION,
                    "recorded": flight_recorder().recorded,
                    "dropped": flight_recorder().dropped,
                    "spans": [span.as_dict() for span in spans],
                },
            )
            return
        match = _JOB_PATH.match(path)
        if match:
            job_id, sub = match.group(1), match.group(2) or ""
            if sub == "/trace":
                # the tier-ladder journey (observe/journey.py): what
                # happened to this job, in order, with timestamps
                from mythril_tpu_torch import observe

                job = self.engine.queue.get(job_id)
                if job is None:
                    self._reply(404, {"error": f"unknown job {job_id}"})
                    return
                doc = observe.assemble_journey(job.journey_id)
                if doc is None:
                    from mythril_tpu_torch.observe import journey as _journey

                    doc = {
                        "schema_version": _journey.SCHEMA_VERSION,
                        "journey_id": job.journey_id,
                        "tiers": [],
                        "tier_dwell_s": {},
                        "events": [],
                        "wall_s": 0.0,
                    }
                doc["state"] = job.state
                self._reply(200, doc)
                return
            if sub == "/report":
                wait_s = min(float(params.get("wait_s", 30.0)), 300.0)
                job = self.engine.queue.wait_terminal(job_id, wait_s)
            else:
                job = self.engine.queue.get(job_id)
            if job is None:
                self._reply(404, {"error": f"unknown job {job_id}"})
                return
            self._reply(200, job.as_dict())
            return
        self._reply(404, {"error": f"no route {path}"})

    # -- POST ----------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802
        path, _ = self._query()
        if path == "/v1/drain":
            # ack first: the drain blocks until checkpoints are flushed
            self._reply(202, {"draining": True})
            threading.Thread(
                target=self.engine.drain, name="myth-serve-drain",
                daemon=True,
            ).start()
            return
        if path != "/v1/jobs":
            self._reply(404, {"error": f"no route {path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            job = Job(
                code_hex=body["code"],
                max_waves=body.get("max_waves"),
                deadline_s=body.get("deadline_s"),
                host_walk=body.get("host_walk"),
                lanes=body.get("lanes"),
                idempotency_key=body.get("idempotency_key"),
                frontier=body.get("frontier"),
            )
        except (KeyError, ValueError, TypeError) as why:
            self._reply(400, {"error": f"bad request: {why}"})
            return
        try:
            # submit returns the CANONICAL job: a known idempotency
            # key maps a retried submit back to the existing job instead
            # of double-running it
            canonical = self.engine.submit(job)
        except QueueRefusal as refusal:
            self._reply(
                _REFUSAL_STATUS.get(refusal.reason, 503),
                {"error": str(refusal), "reason": refusal.reason},
                headers={"Retry-After": str(
                    _RETRY_AFTER.get(refusal.reason, 1)
                )},
            )
            return
        payload = {"job_id": canonical.id, "state": canonical.state}
        if canonical.id != job.id:
            payload["deduped"] = True
        self._reply(202, payload)


class AnalysisServer:
    """The embeddable server: engine + HTTP listener + drain wiring.

    `serve` runs it until drained; the tests and chip_smoke.py run it
    in-process (port 0 picks a free port)."""

    def __init__(
        self,
        config: Optional[ServiceConfig] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        start_engine: bool = True,
    ) -> None:
        self.engine = AnalysisEngine(config)
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.engine = self.engine  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None
        self._start_engine = start_engine
        self._closed = False
        self._sampler_stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "AnalysisServer":
        if self._start_engine:
            self.engine.start()
        if self._http_thread is None:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="myth-serve-http",
                daemon=True,
            )
            self._http_thread.start()
        if self._sampler is None:
            # the health/saturation sampler: rolls the SLO engine and
            # the device monitor on a clock so mtpu_health_state and
            # mtpu_device_* stay live without a scrape in the loop
            from mythril_tpu_torch import observe

            def _sample_loop():
                while not self._sampler_stop.wait(
                    self.engine.cfg.health_interval_s
                ):
                    try:
                        self.engine.health.sample()
                        observe.device_monitor().sample()
                    except Exception:  # telemetry never sinks serving
                        log.debug("observe sampler tick failed",
                                  exc_info=True)

            try:  # one synchronous tick: the first scrape sees gauges
                self.engine.health.sample()
                observe.device_monitor().sample()
            except Exception:
                log.debug("initial observe sample failed", exc_info=True)
            self._sampler = threading.Thread(
                target=_sample_loop, name="myth-observe-sampler",
                daemon=True,
            )
            self._sampler.start()
        return self

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain. Chains to the previously
        installed handler, mirroring the courtesy resilience's
        supervisor extends to us."""
        def _drain_handler(signum, frame, _previous={}):
            log.info("signal %s: draining the analysis service", signum)
            threading.Thread(
                target=self.close, name="myth-serve-drain", daemon=True
            ).start()
            previous = _previous.get(signum)
            if callable(previous) and previous not in (
                signal.default_int_handler,
            ):
                previous(signum, frame)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.signal(sig, _drain_handler)
            except (ValueError, OSError):
                continue  # not the main thread / exotic embedding
            if prev is not _drain_handler:
                _drain_handler.__defaults__[0][sig] = prev

    def drained(self, timeout_s: Optional[float] = 300.0) -> bool:
        """Block until the drain completes (None = forever)."""
        return self.engine._drained.wait(timeout_s)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._sampler_stop.set()
        self.engine.drain()
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "AnalysisServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve_forever(
    config: Optional[ServiceConfig] = None,
    host: str = "127.0.0.1",
    port: int = 7341,
) -> None:
    """The `serve` entry: run until a drain (SIGTERM/SIGINT or POST
    /v1/drain) completes."""
    server = AnalysisServer(config, host=host, port=port).start()
    server.install_signal_handlers()
    print(
        f"serve: listening on {server.url} "
        f"(arena {server.engine.cfg.stripes}x"
        f"{server.engine.cfg.lanes_per_stripe} lanes on "
        f"{server.engine.device}, "
        f"queue {server.engine.cfg.queue_capacity})",
        flush=True,
    )
    try:
        server.drained(timeout_s=None)
    except KeyboardInterrupt:
        pass
    server.close()
    print("serve: drained, bye", flush=True)
