"""Tiered storage: the port's ``tier`` package and the fragment's tier
face against the JAX package's on the CPU (the cases of
``tests/test_tier.py``).

- the cold file, the ``.blob`` stub, the manifest and every blob object
  are byte-equal for the same seeded fragment, and a directory pushed by
  either package is fetched by the other;
- the randomized cold-against-resident differential (demote, partial
  fault, re-chill, promote, push, fetch), over every read route of the
  port's fragment, against a resident copy and against the JAX fragment
  on the same schedule;
- the ledger's victim order (over-share tenants first, then LRU, never
  a pinned entry) on the same touches;
- the crash windows (stub and data file together, a staging leftover, a
  SIGKILL mid-transition) and the failure legs (a torn promotion, a
  failed push, a corrupt fetch, a corrupt cold fault), which degrade the
  same way in both packages and never answer wrong;
- the JAX faults of ROADMAP 3.16, each shown on the JAX package and held
  fixed in the port.
"""

import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest

from pilosa_tpu.fault import failpoints as jfp
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.storage import fragment as jfragment
from pilosa_tpu.storage.fragment import TopOptions as JTop
from pilosa_tpu.storage.integrity import CorruptionError as JCorruption
from pilosa_tpu.tier import blob as jblob
from pilosa_tpu.tier import ledger as jledger
from pilosa_tpu.tier.manager import ColdFetchError as JColdFetch
from pilosa_tpu.tier.manager import TierManager as JManager

from pilosa_tpu_torch.fault import failpoints as tfp
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.storage.integrity import CorruptionError as TCorruption
from pilosa_tpu_torch.storage.fragment import TopOptions as TTop
from pilosa_tpu_torch.tier import blob as tblob
from pilosa_tpu_torch.tier import ledger as tledger
from pilosa_tpu_torch.tier.manager import ColdFetchError as TColdFetch
from pilosa_tpu_torch.tier.manager import TierManager as TManager

JAX = dict(name="jax", Holder=JHolder, Manager=JManager, blob=jblob,
           ledger=jledger, fp=jfp, ColdFetch=JColdFetch,
           Corruption=JCorruption, Top=JTop)
TORCH = dict(name="torch", Holder=THolder, Manager=TManager, blob=tblob,
             ledger=tledger, fp=tfp, ColdFetch=TColdFetch,
             Corruption=TCorruption, Top=TTop)
PKGS = (JAX, TORCH)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for p in PKGS:
        p["fp"].disarm_all()


def _rows(seed, n_rows, per_row):
    """{row: sorted slice-local columns}, from a seed."""
    rng = np.random.default_rng(seed)
    return {r: sorted(np.unique(rng.integers(0, 1 << 20, size=per_row))
                      .tolist()) for r in range(n_rows)}


def _fragment(pkg, path, rows):
    """A holder holding one snapshotted fragment (index i, frame f,
    slice 0) with ``rows`` set bit by bit, in a fixed order."""
    h = pkg["Holder"](str(path))
    h.open()
    view = (h.create_index("i").create_frame("f")
            .create_view_if_not_exists("standard"))
    frag = view.create_fragment_if_not_exists(0)
    for r, cols in rows.items():
        for c in cols:
            frag.set_bit(r, c)
    frag.snapshot()
    return h, frag


def _manager(pkg, h, tmp, **kw):
    kw.setdefault("resident_budget", 1 << 30)
    kw.setdefault("cold_dir", os.path.join(str(tmp), "_tier"))
    kw.setdefault("blob", "dir")
    kw.setdefault("pace_s", 0.0)
    mgr = pkg["Manager"](h, **kw)
    h.tier = mgr
    mgr.sync()
    return mgr


def _bits(frag, r):
    return sorted(frag.row(r).bits())


def _store_objects(root):
    out = {}
    for dirpath, _d, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# -- bytes on disk ------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 5])
def test_cold_file_stub_manifest_and_objects_are_the_jax_bytes(tmp_path,
                                                               seed):
    rows = _rows(seed, 5, 2500)
    out = []
    for pkg in PKGS:
        d = tmp_path / pkg["name"]
        h, frag = _fragment(pkg, d, rows)
        mgr = _manager(pkg, h, d)
        try:
            size = frag.demote_cold()
            cold = open(frag.path, "rb").read()
            cache = open(frag.path + ".cache", "rb").read()
            assert mgr.push_blob(frag)
            stub = open(frag.path + ".blob", "rb").read()
            objects = _store_objects(os.path.join(str(d), "_tier", "blob"))
            listing = sorted(os.listdir(os.path.dirname(frag.path)))
            state = {k: v for k, v in mgr.state().items()
                     if k not in ("store", "residentBytes")}
        finally:
            h.close()
        out.append((size, cold, cache, stub, objects, listing, state))
    assert out[0] == out[1]
    assert "i/f/standard/0/manifest.json" in out[1][4]


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_a_pushed_directory_opens_in_the_other_package(tmp_path, writer,
                                                        reader):
    rows = _rows(9, 4, 3000)
    d = tmp_path / "data"
    h, frag = _fragment(writer, d, rows)
    mgr = _manager(writer, h, d)
    hot_top = [(p.id, p.count) for p in frag.top()]
    assert frag.demote_cold() > 0 and mgr.push_blob(frag)
    h.close()
    h2 = reader["Holder"](str(d))
    h2.open()
    try:
        frag2 = h2.fragment("i", "f", "standard", 0)
        assert frag2.tier_state == "blob"
        mgr2 = _manager(reader, h2, d)
        assert _bits(frag2, 1) == rows[1]
        assert frag2.tier_state == "cold" and mgr2.blob_fetches == 1
        assert [(p.id, p.count) for p in frag2.top()] == hot_top
        assert frag2.tier_state == "hot"
        assert [_bits(frag2, r) for r in rows] == list(rows.values())
    finally:
        h2.close()


# -- the randomized differential over every read route ------------------------


def _routes(frag, pkg, rows, r):
    """Every read route of the fragment at row ``r``: the port's
    routes; for the JAX fragment only those both packages have."""
    n = len(rows)
    ids = sorted({r, (r + 1) % n, (r + 3) % n})
    out = {"row": _bits(frag, r)}
    words = np.zeros(1 << 15, dtype=np.uint32)
    out["pack_row"] = frag.pack_row(r, words).tobytes()
    out["pack_row_uncached"] = frag.pack_row(
        r, np.zeros(1 << 15, dtype=np.uint32), cached=False).tobytes()
    for op in ("or", "and", "andnot"):
        out["fold_" + op] = frag.fold_rows(op, ids).tolist()
    idx, vals = frag.sparse_row_pairs(r)
    out["sparse"] = (np.asarray(idx).tolist(), np.asarray(vals).tolist())
    src = frag.row((r + 2) % n)
    out["top"] = [(p.id, p.count) for p in frag.top(pkg["Top"](n=3))]
    out["top_ids"] = [(p.id, p.count)
                      for p in frag.top(pkg["Top"](row_ids=ids))]
    out["top_src"] = [(p.id, p.count)
                      for p in frag.top(pkg["Top"](n=3, src=src))]
    out["top_tanimoto"] = [(p.id, p.count) for p in frag.top(
        pkg["Top"](n=3, src=src, tanimoto_threshold=1))]
    if pkg is TORCH:
        out["positions"] = frag.positions().tolist()
        out["present_rows"] = frag.present_rows().tolist()
        out["blocks"] = frag.blocks()
        out["block_data"] = [a.tolist() for a in (
            lambda ps: (ps.row_ids, ps.column_ids))(frag.block_data(0))]
        tw = io.BytesIO()
        frag.write_to(tw)
        tw.seek(0)
        with tarfile.open(fileobj=tw, mode="r|") as tr:
            out["write_to"] = [(m.name, tr.extractfile(m).read()
                                if m.size else b"") for m in tr]
        out["row_count"] = frag.row_count(r)
    return out


@pytest.mark.parametrize("seed", [3, 8])
def test_randomized_cold_vs_resident_over_every_read_route(tmp_path,
                                                           seed):
    """Across random demote / partial-fault / re-chill / promote / push
    / fetch schedules, every read of the tiered port fragment equals the
    resident copy's, and the routes both packages have equal the JAX
    fragment's on the same schedule."""
    rows = _rows(seed, 6, 1500)
    frags, mgrs, holders = {}, {}, []
    for pkg in PKGS:
        h, f = _fragment(pkg, tmp_path / pkg["name"], rows)
        holders.append(h)
        frags[pkg["name"]] = f
        mgrs[pkg["name"]] = _manager(pkg, h, tmp_path / pkg["name"])
    ref_h, ref = _fragment(TORCH, tmp_path / "resident", rows)
    holders.append(ref_h)
    try:
        rng = np.random.default_rng(seed + 100)
        for step in range(24):
            op = int(rng.integers(0, 10))
            r = int(rng.integers(0, len(rows)))
            states = []
            for pkg in PKGS:
                f, mgr = frags[pkg["name"]], mgrs[pkg["name"]]
                if op < 2 and f.tier_state == "hot":
                    f.demote_cold()
                elif op < 3 and f.tier_state == "cold":
                    f.tier_rechill()
                elif op < 4 and f.tier_state == "cold":
                    mgr.push_blob(f)
                elif op < 5 and f.tier_state != "hot":
                    f.promote(trigger="read")
                states.append(f.tier_state)
            assert states[0] == states[1], f"step {step}"
            if op >= 5 and states[1] != "hot":
                # A read that faults one row only: the cold fault set
                # shrinks (or the blob fetch lands cold) in both.
                got = [_bits(frags[p["name"]], r) for p in PKGS]
                assert got == [rows[r], rows[r]]
                assert (frags["jax"].tier_state
                        == frags["torch"].tier_state)
                if frags["torch"].tier_state == "cold":
                    assert (sorted(frags["jax"]._cold_pending)
                            == sorted(frags["torch"]._cold_pending))
                continue
            want = _routes(ref, TORCH, rows, r)
            got = _routes(frags["torch"], TORCH, rows, r)
            assert got == want, f"step {step} from {states[1]}"
            jgot = _routes(frags["jax"], JAX, rows, r)
            assert jgot == {k: got[k] for k in jgot}, f"step {step}"
            assert frags["torch"].tier_state == frags["jax"].tier_state
        assert (mgrs["jax"].blob_pushes, mgrs["jax"].blob_fetches) == (
            mgrs["torch"].blob_pushes, mgrs["torch"].blob_fetches)
    finally:
        for h in holders:
            h.close()


def test_demotion_drops_every_derived_cache(tmp_path):
    rows = _rows(4, 4, 2000)
    h, frag = _fragment(TORCH, tmp_path, rows)
    _manager(TORCH, h, tmp_path)
    try:
        frag.positions()
        frag.blocks()
        _bits(frag, 1)
        frag.top(TTop(n=2, src=frag.row(2)))
        gen0, epoch0 = frag.device.generation, frag._epoch
        assert frag.demote_cold() > 0
        assert frag._epoch > epoch0 and frag.device.generation > gen0
        assert frag._positions is None and frag._blocks is None
        assert not frag._src_counts and not frag.device._host_rows
        assert len(frag.cache) == 0 and not frag._cache_complete
        pending = len(frag._cold_pending)
        _bits(frag, 0)
        assert len(frag._cold_pending) < pending
        gen1 = frag.device.generation
        assert frag.tier_rechill() and frag.device.generation > gen1
        assert len(frag._cold_pending) == pending
        assert not frag.device._host_rows and frag._positions is None
    finally:
        h.close()


def test_write_on_cold_and_blob_promotes_and_lands(tmp_path):
    rows = _rows(6, 3, 800)
    out = []
    for pkg in PKGS:
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        mgr = _manager(pkg, h, tmp_path / pkg["name"])
        try:
            assert frag.demote_cold() > 0
            frag.set_bit(0, 7)
            st = [frag.tier_state]
            assert frag.demote_cold() > 0 and mgr.push_blob(frag)
            frag.import_positions(np.asarray([(1 << 20) + 9],
                                             dtype=np.uint64))
            st.append(frag.tier_state)
            out.append((st, _bits(frag, 0)[:3], _bits(frag, 1)[:3],
                        [(p.id, p.count) for p in frag.top()]))
        finally:
            h.close()
    assert out[0] == out[1] and out[1][0] == ["hot", "hot"]


# -- the ledger ---------------------------------------------------------------


class _FakeFrag:
    def __init__(self, index, slice):
        self.index, self.frame, self.view = index, "f", "standard"
        self.slice = slice


def _victims(pkg, seed):
    rng = np.random.default_rng(seed)
    led = pkg["ledger"].ResidencyLedger()
    frags = [_FakeFrag(f"t{int(rng.integers(0, 3))}", s)
             for s in range(12)]
    clock = [100.0]

    def tick():
        clock[0] += 1.0
        return clock[0]

    for f in frags:
        led.track(f, ("hot", "cold")[int(rng.integers(0, 2))],
                  int(rng.integers(100, 1000)))
        if led.get(f).tier == "cold":
            led.note_fault(f, int(rng.integers(0, 500)))
    for i in rng.permutation(len(frags)).tolist():
        led.touch(frags[i], frags[i].index)
        led.get(frags[i]).last_touch = tick()
    led.pin(frags[int(rng.integers(0, len(frags)))], True)
    shares = {"t0": 0.1, "t1": 0.5, "": 1.0}
    return ([led.victims(need, 4000, sh)
             for need in (200, 1500, 10 ** 6)
             for sh in (None, shares)],
            led.resident_bytes(), led.tenant_resident(), led.counts(),
            [(e.key, e.tier) for e in map(led.get, frags)])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ledger_victim_order_equals_jax(seed):
    assert _victims(TORCH, seed) == _victims(JAX, seed)


def test_ledger_never_picks_a_pinned_entry_and_drains_over_share_first():
    led = tledger.ResidencyLedger()
    fb = _FakeFrag("b", 9)
    led.track(fb, "hot", 200)
    led.touch(fb, "b")
    led.get(fb).last_touch = 1.0
    for i in range(3):
        f = _FakeFrag("a", i)
        led.track(f, "hot", 200)
        led.touch(f, "a")
        led.get(f).last_touch = 2.0 + i
    out = led.victims(300, 1000, {"a": 0.3, "b": 0.5})
    assert out and all(k[0] == "a" for k in out)
    assert led.victims(300, 1000, None)[0][0] == "b"
    led.pin(fb, True)
    assert all(k[0] == "a" for k in led.victims(10 ** 6, 1000, None))


# -- crash windows ------------------------------------------------------------


def _pushed(pkg, tmp, rows):
    h, frag = _fragment(pkg, tmp, rows)
    mgr = _manager(pkg, h, tmp)
    assert frag.demote_cold() > 0 and mgr.push_blob(frag)
    assert frag.tier_state == "blob" and frag.storage is None
    return h, frag, mgr


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p["name"])
def test_crash_window_stub_and_data_file_coexist(tmp_path, pkg):
    """A kill between the stub's write and the data file's removal
    leaves both: the data file wins at reopen and the stub goes."""
    rows = _rows(2, 3, 1200)
    h, frag = _fragment(pkg, tmp_path, rows)
    mgr = _manager(pkg, h, tmp_path)
    assert frag.demote_cold() > 0
    shutil.copy(frag.path, frag.path + ".keep")
    assert mgr.push_blob(frag)
    os.rename(frag.path + ".keep", frag.path)
    h.close()
    h2 = pkg["Holder"](str(tmp_path))
    h2.open()
    try:
        frag2 = h2.fragment("i", "f", "standard", 0)
        assert frag2.tier_state == "hot"
        assert not os.path.exists(frag2.path + ".blob")
        assert [_bits(frag2, r) for r in rows] == list(rows.values())
    finally:
        h2.close()


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p["name"])
def test_crash_window_fetch_staging_leftover(tmp_path, pkg):
    rows = _rows(3, 3, 1200)
    h, frag, _mgr = _pushed(pkg, tmp_path, rows)
    h.close()
    with open(frag.path + ".fetching", "wb") as f:
        f.write(b"torn garbage")
    h2 = pkg["Holder"](str(tmp_path))
    h2.open()
    try:
        frag2 = h2.fragment("i", "f", "standard", 0)
        assert frag2.tier_state == "blob"
        _manager(pkg, h2, tmp_path)
        assert [_bits(frag2, r) for r in rows] == list(rows.values())
        assert not os.path.exists(frag2.path + ".fetching")
    finally:
        h2.close()


_KILL_CHILD = """
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.tier.manager import TierManager

data = sys.argv[1]
h = Holder(data)
h.open()
view = (h.create_index("i").create_frame("f")
        .create_view_if_not_exists("standard"))
frag = view.create_fragment_if_not_exists(0)
rng = np.random.default_rng(17)
for r in range(4):
    cols = np.unique(rng.integers(0, 1 << 20, size=1500))
    frag.import_positions(np.uint64(r << 20) + cols.astype(np.uint64))
frag.snapshot()
mgr = TierManager(h, resident_budget=1 << 30,
                  cold_dir=os.path.join(data, "_tier"), blob="dir",
                  pace_s=0.0)
h.tier = mgr
mgr.sync()
print("READY", flush=True)
while True:  # demote, fault, promote, push, fetch until killed
    frag.demote_cold()
    frag.row(1)
    frag.promote(trigger="read")
    frag.demote_cold()
    mgr.push_blob(frag)
    frag.row(2)
    frag.promote(trigger="read")
"""


@pytest.mark.parametrize("trial", range(3))
def test_sigkill_mid_transition_reopens_exact(tmp_path, trial):
    """SIGKILL a process cycling demote / fault / promote / push /
    fetch at a point that moves with the trial: the reopen sees exactly
    the snapshotted bits."""
    script = tmp_path / "child.py"
    script.write_text(_KILL_CHILD.format(repo=REPO))
    data = str(tmp_path / "data")
    rng = np.random.default_rng(17)
    expect = {r: sorted(np.unique(rng.integers(0, 1 << 20, size=1500))
                        .tolist()) for r in range(4)}
    proc = subprocess.Popen([sys.executable, str(script), data],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        time.sleep(0.05 + 0.15 * trial)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    h = THolder(data)
    h.open()
    try:
        frag = h.fragment("i", "f", "standard", 0)
        assert frag is not None
        _manager(TORCH, h, data)
        for r, bits in expect.items():
            assert _bits(frag, r) == bits, f"row {r} after SIGKILL"
    finally:
        h.close()


# -- failure legs: degrade, never lie -----------------------------------------


def _leg(pkg, tmp_path, rows, leg):
    """Run one failure leg; returns what a caller observes."""
    fp = pkg["fp"]
    if leg == "failed_push":
        h, frag = _fragment(pkg, tmp_path, rows)
        mgr = _manager(pkg, h, tmp_path)
        try:
            assert frag.demote_cold() > 0
            with fp.injected("tier.fetch", "partition(push)"):
                pushed = mgr.push_blob(frag)
            return (pushed, frag.tier_state, os.path.exists(frag.path),
                    [_bits(frag, r) for r in rows], mgr.errors)
        finally:
            h.close()
    h, frag, mgr = _pushed(pkg, tmp_path, rows)
    try:
        if leg == "torn_promotion":
            with fp.injected("tier.fetch", "torn(64)"):
                with pytest.raises(pkg["ColdFetch"]):
                    frag.promote(trigger="read")
        else:  # corrupt_fetch: a rotted block object in the store
            for dirpath, _d, files in os.walk(
                    os.path.join(str(tmp_path), "_tier", "blob")):
                for name in files:
                    if name.startswith("blk-0-"):
                        p = os.path.join(dirpath, name)
                        raw = bytearray(open(p, "rb").read())
                        raw[0] ^= 0xFF
                        open(p, "wb").write(bytes(raw))
            with pytest.raises(pkg["ColdFetch"]):
                frag.row(0)
        failed = (frag.tier_state, os.path.exists(frag.path),
                  mgr.slice_blocked("i", 0), mgr.fetch_failures,
                  sorted(b["slice"] for b in mgr.state()["blocked"]))
        if leg == "corrupt_fetch":
            for dirpath, _d, files in os.walk(
                    os.path.join(str(tmp_path), "_tier", "blob")):
                for name in files:
                    if name.startswith("blk-0-"):
                        p = os.path.join(dirpath, name)
                        raw = bytearray(open(p, "rb").read())
                        raw[0] ^= 0xFF
                        open(p, "wb").write(bytes(raw))
        fp.disarm_all()
        summary = mgr.pass_once()
        healed = (summary["retried"], mgr.slice_blocked("i", 0),
                  [_bits(frag, r) for r in rows], frag.tier_state)
        return failed, healed
    finally:
        h.close()


@pytest.mark.parametrize("leg", ["failed_push", "torn_promotion",
                                 "corrupt_fetch"])
def test_failure_legs_degrade_the_same_and_never_lie(tmp_path, leg):
    rows = _rows(12, 3, 900)
    out = [_leg(p, tmp_path / p["name"], rows, leg) for p in PKGS]
    assert out[0] == out[1]
    if leg != "failed_push":
        failed, healed = out[1]
        assert failed[:3] == ("blob", False, True)
        assert healed[1] is False and healed[2] == list(rows.values())


def test_corrupt_cold_fault_quarantines_in_both(tmp_path):
    rows = _rows(13, 3, 900)
    out = []
    for pkg in PKGS:
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        _manager(pkg, h, tmp_path / pkg["name"])
        try:
            assert frag.demote_cold() > 0
            with pkg["fp"].injected("tier.fault", "corrupt*1"):
                with pytest.raises(pkg["Corruption"]):
                    frag.row(0)
            out.append((frag.quarantined, frag.tier_state,
                        frag.quarantine_reason.split(" (")[0],
                        h.quarantine.slice_blocked("i", 0)))
        finally:
            h.close()
    assert out[0] == out[1] == [
        (True, "cold", "cold block fault crc mismatch", True)][0]


def test_fault_span_confines_corrupt_flips(tmp_path):
    """``span`` keeps every corrupt flip inside the byte range given."""
    path = tmp_path / "f"
    path.write_bytes(bytes(4096))
    outs = []
    for fp in (jfp, tfp):
        path.write_bytes(bytes(4096))
        reg = fp.Failpoints(seed=3)
        reg.arm("tier.fault", "corrupt(40)")
        reg.hit("tier.fault", path=str(path), span=(1000, 24))
        raw = path.read_bytes()
        outs.append([i for i, b in enumerate(raw) if b])
    assert outs[0] == outs[1] and outs[1]
    assert all(1000 <= i < 1024 for i in outs[1])


def test_tier_sites_arm_in_both_packages():
    for site in ("tier.fault", "tier.fetch"):
        assert site in tfp.SITES and site in jfp.SITES
        reg = tfp.Failpoints(seed=1)
        reg.arm(site, "error*1")
        with pytest.raises(tfp.FailpointError):
            reg.hit(site)


# -- JAX faults not copied (ROADMAP 3.16) -------------------------------------


def test_topn_after_a_blob_round_trip_ranks_every_row(tmp_path,
                                                      monkeypatch):
    """A blob push drops the ``.cache`` sidecar. At promotion the JAX
    fragment rebuilds the count cache only up to _POSITIONS_CACHE_BITS
    bits and ranks an empty cache past it (lowered here to show it on a
    small fragment); the port rebuilds it from the container table."""
    monkeypatch.setattr(jfragment, "_POSITIONS_CACHE_BITS", 100)
    rows = _rows(21, 4, 1000)
    out = []
    for pkg in PKGS:
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        mgr = _manager(pkg, h, tmp_path / pkg["name"])
        try:
            hot = [(p.id, p.count) for p in frag.top(pkg["Top"](n=3))]
            assert frag.demote_cold() > 0 and mgr.push_blob(frag)
            out.append((hot, [(p.id, p.count)
                              for p in frag.top(pkg["Top"](n=3))]))
        finally:
            h.close()
    (jhot, jblob_top), (thot, tblob_top) = out
    assert jhot == thot and len(thot) == 3
    assert jblob_top == []          # the JAX fault
    assert tblob_top == thot


def test_closing_a_cold_fragment_keeps_its_cache_sidecar(tmp_path):
    """The JAX fragment flushes its empty placeholder cache when a cold
    fragment closes, erasing the sidecar the demotion wrote."""
    rows = _rows(22, 3, 700)
    sidecars = []
    for pkg in PKGS:
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        _manager(pkg, h, tmp_path / pkg["name"])
        assert frag.demote_cold() > 0
        at_demotion = open(frag.cache_path, "rb").read()
        h.close()
        sidecars.append((at_demotion, open(frag.cache_path, "rb").read()))
    (j0, j1), (t0, t1) = sidecars
    assert j0 == t0 and len(t0) > 2
    assert j1 != j0                  # the JAX fault: emptied at close
    assert t1 == t0


def _read_route(pkg, frag, route):
    if route == "blocks":
        return frag.blocks()
    if route == "write_to":
        return len(_tar(frag))
    # The export's positions: the port's positions(), the JAX
    # fragment's snapshot_value_chunks().
    if pkg is TORCH:
        return frag.positions().tolist()
    return np.concatenate(list(frag.snapshot_value_chunks())).tolist()


@pytest.mark.parametrize("route", ["blocks", "write_to", "export"])
def test_anti_entropy_stream_and_export_read_a_blob_fragment(tmp_path,
                                                             route):
    """The JAX fragment's anti-entropy checksums, tar stream and export
    read a blob fragment ungated and fail (no storage, no data file);
    the port fetches it first and answers as the resident fragment
    does."""
    rows = _rows(23, 3, 900)
    answers = []
    for pkg in PKGS:
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        mgr = _manager(pkg, h, tmp_path / pkg["name"])
        try:
            hot = _read_route(pkg, frag, route)
            assert frag.demote_cold() > 0 and mgr.push_blob(frag)
            try:
                got = _read_route(pkg, frag, route)
            except (AttributeError, OSError) as e:
                got = type(e).__name__
            answers.append((hot, got))
        finally:
            h.close()
    (jhot, jgot), (thot, tgot) = answers
    assert jhot == thot
    assert jgot in ("AttributeError", "FileNotFoundError")
    assert tgot == thot


def test_a_blob_push_drops_what_was_faulted_in_while_cold(tmp_path):
    """The JAX manager's push keeps the fragment's device generation
    from its cold life, so a device slab built while cold still answers
    after the push, without a fetch; the port's push moves it. Both drop
    the row cache with the storage."""
    rows = _rows(25, 3, 900)
    out = []
    for pkg in PKGS:
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        mgr = _manager(pkg, h, tmp_path / pkg["name"])
        try:
            assert frag.demote_cold() > 0
            _bits(frag, 1)
            gen = frag.device.generation
            assert mgr.push_blob(frag)
            out.append((frag.device.generation > gen,
                        frag.row_cache.fetch(1) is None))
        finally:
            h.close()
    assert out[0] == (False, True)   # the JAX fault
    assert out[1] == (True, True)


def _tar(frag):
    w = io.BytesIO()
    frag.write_to(w)
    return w.getvalue()


def test_restore_into_a_blob_fragment_is_not_undone_by_its_stub(tmp_path):
    """A tar restore into a blob fragment: the JAX fragment keeps its
    blob state, so the next read fetches the old bytes over the
    restored file; the port's restore makes the new file the record."""
    rows = _rows(24, 2, 600)
    other = {0: [5, 6, 7], 1: [9]}
    out = []
    for pkg in PKGS:
        src_h, src = _fragment(pkg, tmp_path / (pkg["name"] + "_src"),
                               other)
        stream = io.BytesIO(_tar(src))
        src_h.close()
        h, frag = _fragment(pkg, tmp_path / pkg["name"], rows)
        mgr = _manager(pkg, h, tmp_path / pkg["name"])
        try:
            assert frag.demote_cold() > 0 and mgr.push_blob(frag)
            frag.read_from(stream)
            out.append((frag.tier_state, _bits(frag, 0), _bits(frag, 1)))
        finally:
            h.close()
    assert out[0][1:] == (rows[0], rows[1])     # the JAX fault
    assert out[1] == ("hot", other[0], other[1])


# -- the blob store -----------------------------------------------------------


def test_blob_store_specs_and_listing_equal_jax(tmp_path):
    out = []
    for pkg in PKGS:
        b = pkg["blob"]
        d = tmp_path / pkg["name"]
        assert b.open_blob_store("", str(d)) is None
        s = b.open_blob_store("dir", str(d))
        s2 = b.open_blob_store(f"dir:{d}/custom", str(d))
        with pytest.raises(ValueError):
            b.open_blob_store("s3://nope", str(d))
        with pytest.raises(ValueError):
            s.put("../x", b"")
        for k in ("a/b/c", "a/d", "e"):
            s.put(k, k.encode())
        s.delete("a/d")
        s.delete("missing")
        out.append((os.path.relpath(s.root, str(d)),
                    os.path.relpath(s2.root, str(d)), s.list(),
                    s.list("a/"), s.exists("e"), s.get("a/b/c"),
                    {k: v for k, v in s.state().items() if k != "root"},
                    b.fragment_prefix("i", "f", "standard", 3)))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_object_pool_helpers_equal_jax(tmp_path, seed):
    """build_manifest / push_objects / fetch_objects / verify_objects
    and delete_fragment (the helpers the backup archive reuses) give the
    same manifests, pushes, bytes and verdicts."""
    rows = _rows(seed + 30, 3, 1000)
    h, frag = _fragment(TORCH, tmp_path / "src", rows)
    frag.demote_cold()
    buf = open(frag.path, "rb").read()
    info = frag.storage.footer
    end = info.body_len + info.size
    h.close()
    from pilosa_tpu.storage import roaring as jroaring
    jinfo = jroaring.Bitmap.unmarshal(buf[:end]).footer
    out = []
    for pkg, inf in ((JAX, jinfo), (TORCH, info)):
        b = pkg["blob"]
        store = b.LocalDirBlobStore(str(tmp_path / pkg["name"]))
        man = b.build_manifest(buf[:end], inf)
        first = b.push_objects(store, "p", buf[:end], man)
        again = b.push_objects(store, "p", buf[:end], man)
        got = b.fetch_objects(store, "p", man)
        ok = b.verify_objects(store, "p", man)
        pushed = b.push_fragment(store, "q", buf[:end], inf)
        fetched = b.fetch_fragment(store, "q")
        manifest = store.get("q/manifest.json")
        key = next(k for k in store.list("q/") if "/blk-" in k)
        store.put(key, b"rot")
        bad = b.verify_fragment(store, "q")
        deleted = b.delete_fragment(store, "q")
        missing = b.verify_fragment(store, "q")
        out.append((json.dumps(man, sort_keys=True), first, again,
                    got == buf[:end], ok, pushed, fetched == buf[:end],
                    manifest, bad, deleted, missing, store.list()))
    assert out[0] == out[1]
