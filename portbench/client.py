"""The load generator, in a process of its own (it imports no torch).

    python3 portbench/client.py < plan.json > result.json

The plan gives the server's port, the window's seconds and the request
paths in order: one closed-loop client sends each request when the one
before it has been answered, paths taken in turn until the window ends.
Each request is timed from its send to the end of its answer; a request
that fails or is refused is recorded with its status (0 for no answer).
The result gives, on the host's monotonic clock, the window's start and
the end of its last answer, each request's index, send offset, latency and
status, and every answer's body.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import time

TIMEOUT_S = 120.0


def fetch(port: int, path: str) -> tuple[int, str]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    except (OSError, http.client.HTTPException) as e:
        return 0, repr(e)
    finally:
        conn.close()


def closed_loop(port: int, paths: list, seconds: float) -> tuple[float, list]:
    start = time.perf_counter()
    records = []
    i = 0
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        status, body = fetch(port, paths[i % len(paths)])
        records.append((i, t - start, time.perf_counter() - t, status, body))
        i += 1
    return start, records


def run(plan: dict) -> dict:
    """Run the plan in a client process of its own; its result."""
    proc = subprocess.run([sys.executable, __file__], input=json.dumps(plan), capture_output=True,
                          text=True, timeout=plan["seconds"] + TIMEOUT_S + 60)
    if proc.returncode != 0:
        raise RuntimeError(f"client failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def main() -> int:
    plan = json.loads(sys.stdin.read())
    start, records = closed_loop(plan["port"], plan["paths"], plan["seconds"])
    end = max((start + r[1] + r[2] for r in records), default=start)
    json.dump({"start": start, "end": end, "records": [r[:4] for r in records],
               "bodies": [r[4] for r in records]}, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
