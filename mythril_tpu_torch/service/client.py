"""Thin stdlib client for the analysis service (`python -m
mythril_tpu_torch submit`).

Connection resilience: a refused or reset connection — a server
restarting, a load balancer blip — is retried with capped exponential
backoff instead of surfacing on the first attempt. `submit` mints an
idempotency key BEFORE the first try and sends it on every retry, so a
submit whose response was lost dedupes server-side instead of
double-running the job.

The port's copy of the JAX package's service/client.py.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, Optional


class ServiceError(Exception):
    """A non-2xx answer from the service; carries the HTTP status so
    callers can tell backpressure (429/503) from mistakes (400/404),
    and the server's Retry-After hint (seconds) when it sent one."""

    def __init__(
        self, status: int, payload: Dict,
        retry_after: Optional[float] = None,
    ) -> None:
        super().__init__(payload.get("error") or f"HTTP {status}")
        self.status = status
        self.payload = payload
        self.retry_after = retry_after


def _retry_after_of(why: urllib.error.HTTPError) -> Optional[float]:
    """The Retry-After header as seconds, or None (only the
    delta-seconds form — the service never sends HTTP dates)."""
    try:
        value = why.headers.get("Retry-After")
        return float(value) if value is not None else None
    except (AttributeError, TypeError, ValueError):
        return None


def _retriable(why: Exception) -> bool:
    """Connection-level failures worth a retry: refused (server not
    up yet / restarting), reset (server died mid-exchange), dropped
    without a status line. HTTP errors are NOT retried here — the
    server answered; backpressure handling is the caller's policy."""
    if isinstance(why, urllib.error.HTTPError):
        return False
    if isinstance(why, urllib.error.URLError):
        why = why.reason if isinstance(why.reason, Exception) else why
    return isinstance(
        why,
        (
            ConnectionRefusedError,
            ConnectionResetError,
            ConnectionAbortedError,
            BrokenPipeError,
            http.client.RemoteDisconnected,
            http.client.BadStatusLine,
        ),
    )


class ServiceClient:
    def __init__(
        self,
        url: str,
        timeout_s: float = 10.0,
        retries: int = 3,
        backoff_s: float = 0.2,
        max_backoff_s: float = 2.0,
        honor_retry_after: bool = True,
    ) -> None:
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        #: connection-failure retries per request (0 = fail fast)
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        #: backpressure answers (429/503) carrying a Retry-After hint
        #: are retried after THAT delay (capped by max_backoff_s)
        #: instead of surfacing — the server knows when its queue
        #: clears better than a fixed exponential guess does. The
        #: fleet front turns this OFF: a refusal there means "try the
        #: next replica now", not "wait here".
        self.honor_retry_after = honor_retry_after

    def _request(
        self, path: str, body: Optional[Dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Dict:
        data = None if body is None else json.dumps(body).encode()
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.url + path,
                data=data,
                headers=(
                    {"Content-Type": "application/json"} if data else {}
                ),
                method="POST" if data is not None else "GET",
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s
                ) as response:
                    return json.loads(response.read() or b"{}")
            except urllib.error.HTTPError as why:
                try:
                    payload = json.loads(why.read() or b"{}")
                except Exception:
                    payload = {}
                retry_after = _retry_after_of(why)
                if (
                    self.honor_retry_after
                    and why.code in (429, 503)
                    and retry_after is not None
                    and attempt < self.retries
                ):
                    # the server said WHEN to come back; sleeping its
                    # hint (capped) beats the blind exponential below
                    time.sleep(
                        min(max(0.0, retry_after), self.max_backoff_s)
                    )
                    continue
                raise ServiceError(
                    why.code, payload, retry_after=retry_after
                ) from why
            except Exception as why:
                if attempt >= self.retries or not _retriable(why):
                    raise
                time.sleep(delay)
                delay = min(delay * 2.0, self.max_backoff_s)
        raise AssertionError("unreachable")  # the loop returns/raises

    def submit(
        self,
        code_hex: str,
        max_waves: Optional[int] = None,
        deadline_s: Optional[float] = None,
        host_walk: Optional[bool] = None,
        lanes: Optional[int] = None,
        idempotency_key: Optional[str] = None,
        frontier: Optional[Dict] = None,
    ) -> str:
        return self.submit_ex(
            code_hex,
            max_waves=max_waves,
            deadline_s=deadline_s,
            host_walk=host_walk,
            lanes=lanes,
            idempotency_key=idempotency_key,
            frontier=frontier,
        )["job_id"]

    def submit_ex(
        self,
        code_hex: str,
        max_waves: Optional[int] = None,
        deadline_s: Optional[float] = None,
        host_walk: Optional[bool] = None,
        lanes: Optional[int] = None,
        idempotency_key: Optional[str] = None,
        frontier: Optional[Dict] = None,
    ) -> Dict:
        """`submit` returning the full 202 payload — the fleet front
        needs `state` (an instant-tier settle is already terminal) and
        `deduped` (the replica mapped the idempotency key back to an
        existing job), not just the id."""
        # the key is minted BEFORE the first attempt: every retry of
        # this logical submission carries the same one, so a response
        # lost to a reset/restart dedupes instead of double-running
        if idempotency_key is None:
            idempotency_key = uuid.uuid4().hex
        body = {"code": code_hex, "idempotency_key": idempotency_key}
        for key, value in (
            ("max_waves", max_waves),
            ("deadline_s", deadline_s),
            ("host_walk", host_walk),
            ("lanes", lanes),
            ("frontier", frontier),
        ):
            if value is not None:
                body[key] = value
        payload = self._request("/v1/jobs", body)
        payload.setdefault("idempotency_key", idempotency_key)
        return payload

    def job(self, job_id: str) -> Dict:
        return self._request(f"/v1/jobs/{job_id}")

    def report(self, job_id: str, wait_s: float = 30.0) -> Dict:
        """Long-poll until the job is terminal (or `wait_s` elapses);
        returns the job dict either way."""
        return self._request(
            f"/v1/jobs/{job_id}/report?wait_s={wait_s}",
            timeout_s=wait_s + 10.0,
        )

    def stats(self) -> Dict:
        return self._request("/stats")

    def healthz(self, ready: bool = False) -> Dict:
        """The health payload. `ready=True` asks the readiness probe
        (the status code becomes the answer): a not-ready replica then
        raises ServiceError(503) with the payload attached — exactly
        what a fleet front's routing probe wants to catch."""
        return self._request("/healthz?ready=1" if ready else "/healthz")

    def frontier_export(self, force: bool = False) -> Dict:
        """GET /v1/frontier/export: the draining replica's unfinished
        jobs with their live exploration frontiers (409 wrapped in
        ServiceError when the replica is healthy and not forced)."""
        return self._request(
            "/v1/frontier/export" + ("?force=1" if force else "")
        )

    def drain(self) -> Dict:
        return self._request("/v1/drain", body={})
