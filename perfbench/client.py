"""The closed-loop clients: one process of their own, importing neither
torch nor the program, one thread and one keep-alive connection a
client.

    python3 perfbench/client.py '<json: host, index, mix, frame_rows,
                                  seed, clients, query_string>'

Protocol on stdin and stdout, one line each:

1. prints ``ready`` once every client's streams are built;
2. on ``warm <t_end>`` every client sends its warm-up stream until the
   monotonic clock reads t_end and waits for its last answer; then
   prints ``warmed <requests> <failed> <answers each second>``;
3. on ``go <t0> <t1>`` every client waits for t0, then sends its window
   stream while the clock reads below t1, each request when its last
   answer has come; prints one JSON line per window request, then
   ``done``.

A window request's line: ``[client, i, t_send, t_recv, status, stats,
body]``, the times on the monotonic clock, ``stats`` the X-Pilosa-Stats
header (or null), ``body`` the answer's text.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import traffic  # noqa: E402

TIMEOUT_S = 300.0


class Conn:
    def __init__(self, host: str):
        h, _, p = host.rpartition(":")
        self._hp = (h, int(p))
        self._c = None

    def post(self, path: str, body: str):
        """(status, X-Pilosa-Stats or None, body text); a refused or
        broken connection reads status 0."""
        try:
            if self._c is None:
                self._c = http.client.HTTPConnection(*self._hp,
                                                     timeout=TIMEOUT_S)
            self._c.request("POST", path, body.encode())
            r = self._c.getresponse()
            data = r.read().decode("utf-8", "replace")
            return r.status, r.getheader("X-Pilosa-Stats"), data
        except (OSError, http.client.HTTPException) as e:
            if self._c is not None:
                self._c.close()
            self._c = None
            return 0, None, f"{type(e).__name__}: {e}"


class Client:
    def __init__(self, a: dict, mix: dict, client: int):
        self.id = client
        self.path = f"/index/{a['index']}/query" + a.get("query_string", "")
        self.warm = traffic.Stream(mix, a["frame_rows"], a["seed"], client,
                                   warm=True)
        self.window = traffic.Stream(mix, a["frame_rows"], a["seed"], client)
        self.conn = Conn(a["host"])
        self.sent = self.failed = 0
        self.warm_done: list = []
        self.lines: list = []

    def run_warm(self, t_end: float) -> None:
        while time.monotonic() < t_end:
            pql, _ = self.warm.next()
            status, _, _ = self.conn.post(self.path, pql)
            self.sent += 1
            self.failed += status != 200
            self.warm_done.append(time.monotonic())

    def run_window(self, t0: float, t1: float) -> None:
        while time.monotonic() < t0:
            time.sleep(min(0.001, max(0.0, t0 - time.monotonic())))
        i = 0
        while True:
            pql, _ = self.window.next()
            t_send = time.monotonic()
            if t_send >= t1:
                break
            status, stats, body = self.conn.post(self.path, pql)
            t_recv = time.monotonic()
            self.lines.append(json.dumps(
                [self.id, i, t_send, t_recv, status, stats, body]))
            i += 1


def _all(clients: list, fn, *args) -> None:
    threads = [threading.Thread(target=fn, args=(c,) + args)
               for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main(arg: str) -> int:
    a = json.loads(arg)
    mix = traffic.load(a["mix"])
    clients = [Client(a, mix, i) for i in range(int(a["clients"]))]
    out = sys.stdout
    print("ready", file=out, flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "warm":
            t_warm = time.monotonic()
            _all(clients, Client.run_warm, float(cmd[1]))
            done = [t for c in clients for t in c.warm_done]
            per_s = [0] * (int(max(done, default=t_warm) - t_warm) + 1)
            for t in done:
                per_s[int(t - t_warm)] += 1
            print(f"warmed {sum(c.sent for c in clients)}"
                  f" {sum(c.failed for c in clients)}"
                  f" {json.dumps(per_s, separators=(',', ':'))}",
                  file=out, flush=True)
        elif cmd[0] == "go":
            _all(clients, Client.run_window, float(cmd[1]), float(cmd[2]))
            for c in clients:
                for rec in c.lines:
                    print(rec, file=out)
            print("done", file=out, flush=True)
            return 0
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
