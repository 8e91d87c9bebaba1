"""The operator surface's 15 routes on a port server against a JAX server.

``/``, ``/assets/{file}``, the seven ``/debug/pprof*`` routes,
``/debug/blackbox``, ``POST /debug/blackbox/dump``, ``/debug/capture``,
``/debug/capture/records``, ``/debug/metrics/history`` and
``/debug/sentinel`` answer with the same status and content type on both
servers (default configuration, the same traffic sent to each), the web
console's page and assets with the same bytes, the pprof index and the
disarmed heap report with the same text, and each bad parameter with
the same 400. The JSON answers carry the same keys.
"""

import json
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.server.server import Server as JaxServer
from pilosa_tpu_torch.server.server import Server as PortServer

ROUTES = (
    ("GET", "/"),
    ("GET", "/assets/index.html"),
    ("GET", "/assets/main.js"),
    ("GET", "/assets/style.css"),
    ("GET", "/assets/nope.js"),
    ("GET", "/assets/..%2Fwebui.py"),
    ("GET", "/debug/pprof"),
    ("GET", "/debug/pprof/"),
    ("GET", "/debug/pprof/profile?seconds=0.1"),
    ("GET", "/debug/pprof/profile?seconds=x"),
    ("GET", "/debug/pprof/profile?seconds=nan"),
    ("GET", "/debug/pprof/threads"),
    ("GET", "/debug/pprof/heap"),
    ("GET", "/debug/pprof/heap?n=x"),
    ("POST", "/debug/pprof/heap?op=bad"),
    ("POST", "/debug/pprof/heap?op=stop"),
    ("GET", "/debug/pprof/flame"),
    ("GET", "/debug/pprof/flame?query=nope&since=1m"),
    ("GET", "/debug/pprof/flame?since=bad"),
    ("GET", "/debug/blackbox"),
    ("GET", "/debug/blackbox?limit=2"),
    ("GET", "/debug/blackbox?limit=x"),
    ("POST", "/debug/blackbox/dump"),
    ("GET", "/debug/capture"),
    ("GET", "/debug/capture/records"),
    ("GET", "/debug/capture/records?since=x"),
    ("GET", "/debug/capture/records?scope=cluster"),
    ("GET", "/debug/metrics/history"),
    ("GET", "/debug/metrics/history?family=pilosa_query_duration_seconds"
            "&window=5m&label=lane=read"),
    ("GET", "/debug/metrics/history?window=bad"),
    ("GET", "/debug/metrics/history?label=novalue"),
    ("GET", "/debug/metrics/history?scope=cluster"),
    ("GET", "/debug/sentinel"),
)

# Bodies that must be byte-identical (no clock, path or host in them).
SAME_BYTES = {"/", "/assets/index.html", "/assets/main.js",
              "/assets/style.css", "/debug/pprof", "/debug/pprof/",
              "/debug/pprof/heap", "/debug/pprof/heap?n=x",
              "/debug/pprof/heap?op=bad", "/debug/pprof/heap?op=stop",
              "/debug/pprof/profile?seconds=x",
              "/debug/pprof/flame?since=bad",
              "/debug/blackbox?limit=x",
              "/debug/capture/records?since=x",
              "/debug/metrics/history?window=bad",
              "/debug/metrics/history?label=novalue",
              "/assets/nope.js"}


def _call(host, method, path):
    req = urllib.request.Request(f"http://{host}{path}", method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = tmp_path_factory.mktemp("routes")
    js = JaxServer(str(d / "jax"), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    ps = PortServer(str(d / "port"), host="127.0.0.1:0", device="cpu",
                    warmup=False)
    js.open()
    ps.open()
    for host in (js.host, ps.host):
        for path in ("/index/i", "/index/i/frame/f"):
            assert _call(host, "POST", path)[0] == 200
        for q in (b'SetBit(frame="f", rowID=1, columnID=2)',
                  b'Count(Bitmap(rowID=1, frame="f"))'):
            req = urllib.request.Request(f"http://{host}/index/i/query",
                                         data=q, method="POST")
            urllib.request.urlopen(req, timeout=60).read()
    yield js, ps
    ps.close()
    js.close()


@pytest.mark.parametrize("method,path", ROUTES)
def test_route_answers_alike(servers, method, path):
    js, ps = servers
    jst, jct, jbody = _call(js.host, method, path)
    pst, pct, pbody = _call(ps.host, method, path)
    assert (pst, pct) == (jst, jct), (pbody[:200], jbody[:200])
    assert pst != 404 or path.startswith("/assets/")
    if path in SAME_BYTES:
        assert pbody == jbody
    if pct == "application/json" and pst == 200:
        jdoc, pdoc = json.loads(jbody), json.loads(pbody)
        assert set(pdoc) == set(jdoc)
    if path == "/debug/pprof/profile?seconds=0.1":
        assert pbody.startswith(b"# cpu profile")


def test_each_of_the_15_routes_is_served(servers):
    """None of the 15 routes answers 404 on the port any more."""
    _, ps = servers
    served = {"/", "/assets/{file}", "/debug/pprof", "/debug/pprof/",
              "/debug/pprof/profile", "/debug/pprof/threads",
              "/debug/pprof/heap", "/debug/pprof/flame",
              "/debug/blackbox", "/debug/blackbox/dump", "/debug/capture",
              "/debug/capture/records", "/debug/metrics/history",
              "/debug/sentinel"}
    patterns = {m.pattern[1:-1].replace("(?P<file>[^/]+)", "{file}")
                for _, m, _, _ in ps.handler._routes}
    assert served <= patterns
    # POST and GET of /debug/pprof/heap make 15 with the rest.
    methods = {(meth, m.pattern) for meth, m, _, _ in ps.handler._routes
               if "pprof/heap" in m.pattern}
    assert {meth for meth, _ in methods} == {"GET", "POST"}
