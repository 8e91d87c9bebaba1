"""The port's gossip membership against the JAX package's, on the CPU.

Counterparts of ``tests/test_gossip.py``, each run over clusters whose
nodes are port nodes (``pilosa_tpu_torch.cluster.gossip``), JAX nodes
(``pilosa_tpu.cluster.gossip``) or a mix: join via a seed, the push/pull
status merge (the port's ``NodeStatus`` bytes are the JAX encoding's),
sync and async broadcasts delivered once, transitive membership, death
detection and refutation, revival after a healed partition, asymmetric
loss, HMAC sealing and the ``gossip.deliver`` failpoint. Every node binds
``127.0.0.1:0``, probes every 0.1 s with an explicit suspect window, and
waits poll to a deadline.
"""

from __future__ import annotations

import json
import socket
import time

import pytest

from pilosa_tpu.cluster import gossip as jgossip
from pilosa_tpu.proto import internal_pb2 as jpb

from pilosa_tpu_torch.cluster import gossip as tgossip
from pilosa_tpu_torch.fault import failpoints as tfp
from pilosa_tpu_torch.proto import internal as tpb

MODS = {"port": (tgossip, tpb), "jax": (jgossip, jpb)}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


class RecordingHandler:
    """BroadcastHandler + StatusHandler double of one package."""

    def __init__(self, host: str, pb):
        self.host = host
        self.pb = pb
        self.messages = []
        self.remote_statuses = []

    def receive_message(self, m) -> None:
        self.messages.append(m)

    def local_status(self):
        pb = self.pb
        return pb.NodeStatus(Host=self.host, State="UP", Indexes=[
            pb.Index(Name="i0", MaxSlice=3, Slices=[0, 2],
                     Frames=[pb.Frame(Name="f")])])

    def handle_remote_status(self, status) -> None:
        self.remote_statuses.append(status)


def make_node(kind: str, host: str, seeds=None, **kw):
    # An explicit suspect window: the automatic one at a 0.1 s probe is
    # 0.6 s, short enough for a loaded host to declare a live node dead.
    kw.setdefault("suspect_timeout", 2.0)
    mod, pb = MODS[kind]
    ns = mod.GossipNodeSet(host, gossip_host="127.0.0.1:0",
                           seeds=seeds or [], probe_interval=0.1,
                           probe_timeout=0.2, push_pull_interval=0.3, **kw)
    h = RecordingHandler(host, pb)
    ns.start(h)
    ns.open()
    return ns, h


def wait_until(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def hosts(ns) -> list[str]:
    return [n.host for n in ns.nodes()]


@pytest.fixture(params=PAIRS, ids=["-".join(p) for p in PAIRS])
def pair(request):
    ka, kb = request.param
    a, ha = make_node(ka, "hostA:10101")
    b, hb = make_node(kb, "hostB:10101", seeds=[a.gossip_host])
    try:
        yield a, ha, b, hb
    finally:
        a.close()
        b.close()


def test_join_via_seed(pair):
    a, _, b, _ = pair
    assert wait_until(lambda: len(a.nodes()) == 2 and len(b.nodes()) == 2)
    assert hosts(a) == hosts(b) == ["hostA:10101", "hostB:10101"]


def test_push_pull_merges_status(pair):
    a, ha, b, hb = pair
    for h, peer in ((ha, "hostB:10101"), (hb, "hostA:10101")):
        assert wait_until(lambda: any(s.Host == peer
                                      for s in h.remote_statuses))
        ns = next(s for s in h.remote_statuses if s.Host == peer)
        assert [(ix.Name, ix.MaxSlice, list(ix.Slices),
                 [f.Name for f in ix.Frames]) for ix in ns.Indexes] == \
            [("i0", 3, [0, 2], ["f"])]
    # The port's NodeStatus encoding is the JAX package's, byte for byte.
    assert (RecordingHandler("h:1", tpb).local_status().SerializeToString()
            == RecordingHandler("h:1", jpb).local_status()
            .SerializeToString())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_broadcasts_deliver_once(pair, mode):
    """A sync send reaches the peer over TCP; an async one rides the
    probes' piggyback and is delivered once however many rounds carry
    it, and a repeated send of the same bytes is a new rumor."""
    a, ha, b, hb = pair
    assert wait_until(lambda: len(a.nodes()) == 2 and len(b.nodes()) == 2)
    for sender, pb, h in ((a, ha.pb, hb), (b, hb.pb, ha)):
        def got():
            return [m for m in h.messages
                    if getattr(m, "Index", "") == "dup"]
        for k in (1, 2):
            msg = pb.CreateSliceMessage(Index="dup", Slice=7)
            getattr(sender, f"send_{mode}")(msg)
            assert wait_until(lambda: len(got()) == k)
            time.sleep(0.4)
            assert len(got()) == k
            assert got()[-1].Slice == 7


@pytest.mark.parametrize("kinds", [("port", "port", "port"),
                                   ("port", "jax", "port"),
                                   ("jax", "port", "port")],
                         ids=lambda k: "-".join(k))
def test_three_node_transitive_membership(kinds):
    a, _ = make_node(kinds[0], "hostA:10101")
    nodes = [a]
    try:
        for kind, host in zip(kinds[1:], ("hostB:10101", "hostC:10101")):
            nodes.append(make_node(kind, host, seeds=[a.gossip_host])[0])
        assert wait_until(lambda: all(len(n.nodes()) == 3 for n in nodes))
    finally:
        for n in nodes:
            n.close()


@pytest.mark.parametrize("kinds", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_failure_detection_and_revival(kinds):
    """A closed node is declared dead (the callback sees suspect, then
    dead); the same name restarted rejoins after refuting its death."""
    a, _ = make_node(kinds[0], "hostA:10101", suspect_after=2)
    seen = []
    a.on_state_change = lambda name, state: seen.append((name, state))
    b, _ = make_node(kinds[1], "hostB:10101", seeds=[a.gossip_host],
                     suspect_after=2)
    b2 = None
    try:
        assert wait_until(lambda: len(a.nodes()) == 2)
        b.close()
        assert wait_until(lambda: hosts(a) == ["hostA:10101"],
                          timeout=10.0)
        states = [s for n, s in seen if n == "hostB:10101"]
        assert states[-1] == "dead" and "suspect" in states
        b2, _ = make_node(kinds[1], "hostB:10101", seeds=[a.gossip_host],
                          suspect_after=2)
        assert wait_until(lambda: len(a.nodes()) == 2
                          and len(b2.nodes()) == 2, timeout=10.0)
        assert [s for n, s in seen if n == "hostB:10101"][-1] == "alive"
        assert a.last_activity_age() is not None
    finally:
        a.close()
        if b2 is not None:
            b2.close()


@pytest.mark.parametrize("state", ["dead", "suspect"])
def test_false_rumor_is_refuted(pair, state):
    """A false dead or suspect rumor about a live node reaches it and is
    refuted with a higher incarnation; the accuser flips it back."""
    a, _, b, _ = pair
    assert wait_until(lambda: len(a.nodes()) == 2)
    mod = tgossip if isinstance(a, tgossip.GossipNodeSet) else jgossip
    inc = a._member_snapshot("hostB:10101").incarnation
    a._merge_member(mod.Member("hostB:10101", b.gossip_host, inc, state))
    assert wait_until(
        lambda: a._member_snapshot("hostB:10101").incarnation > inc
        and a._member_snapshot("hostB:10101").state == "alive",
        timeout=10.0)
    assert len(a.nodes()) == 2


@pytest.mark.parametrize("kinds", [("port", "jax", "port"),
                                   ("jax", "port", "port")],
                         ids=lambda k: "-".join(k))
def test_asymmetric_direct_loss_does_not_kill(kinds):
    """With only A's direct pings to B dropped, relay C still reaches B
    (ping-req), so B stays alive at A; once B dies, A's suspicion
    expires into death."""
    a, _ = make_node(kinds[0], "hostA:10101", suspect_after=1,
                     suspect_timeout=0.6)
    b, _ = make_node(kinds[1], "hostB:10101", seeds=[a.gossip_host],
                     suspect_after=1)
    c, _ = make_node(kinds[2], "hostC:10101", seeds=[a.gossip_host],
                     suspect_after=1)
    try:
        assert wait_until(lambda: len(a.nodes()) == 3
                          and len(c.nodes()) == 3)
        b_addr = b.gossip_host
        a.loss_filter = (lambda addr, pkt: addr == b_addr
                         and pkt.get("t") == "ping")
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            assert len(a.nodes()) == 3, "B was condemned despite relays"
            time.sleep(0.05)
        assert a._member_snapshot("hostB:10101").state == "alive"
        b.close()
        assert wait_until(lambda: "hostB:10101" not in hosts(a),
                          timeout=10.0)
    finally:
        for ns in (a, b, c):
            ns.close()


@pytest.mark.parametrize("replay_window", [None, 30.0])
@pytest.mark.parametrize("kinds", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_hmac_seals_the_wire(kinds, replay_window):
    """With a shared key an unsealed datagram is dropped and a sealed one
    absorbed; a port node and a JAX node with the same key join and pass
    sync broadcasts; a node with another key is not heard."""
    kw = {"secret_key": b"swordfish", "replay_window": replay_window}
    a, ha = make_node(kinds[0], "hostA:10101", **kw)
    b, hb = make_node(kinds[1], "hostB:10101", seeds=[a.gossip_host], **kw)
    x, _ = make_node(kinds[1], "hostX:10101", seeds=[a.gossip_host],
                     secret_key=b"other")
    try:
        assert wait_until(lambda: len(a.nodes()) == 2 and len(b.nodes()) == 2)
        b.send_sync(hb.pb.CreateIndexMessage(Index="idx"))
        assert wait_until(lambda: any(getattr(m, "Index", "") == "idx"
                                      for m in ha.messages))
        spoofed = json.dumps({"t": "update", "from": "evil",
                              "updates": [{"name": "evil:10101",
                                           "addr": "127.0.0.1:9", "inc": 5,
                                           "state": "alive"}]}).encode()
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(spoofed, tgossip._split_addr(a.gossip_host))
            time.sleep(0.4)
            assert "evil:10101" not in hosts(a)
            s.sendto(b._seal(spoofed), tgossip._split_addr(a.gossip_host))
        assert wait_until(lambda: "evil:10101" in hosts(a))
        assert "hostX:10101" not in hosts(a)
    finally:
        for ns in (a, b, x):
            ns.close()


def test_deliver_failpoint_drops_one_envelope():
    """``gossip.deliver`` armed on the port drops the next envelope it
    would hand to the server, as the JAX site does."""
    a, _ = make_node("jax", "hostA:10101")
    b, hb = make_node("port", "hostB:10101", seeds=[a.gossip_host])
    try:
        assert wait_until(lambda: len(a.nodes()) == 2)
        tfp.arm("gossip.deliver", "error*1")
        a.send_sync(jpb.CreateIndexMessage(Index="lost"))
        a.send_sync(jpb.CreateIndexMessage(Index="kept"))
        assert wait_until(lambda: [m.Index for m in hb.messages]
                          == ["kept"])
    finally:
        tfp.disarm_all()
        a.close()
        b.close()
