"""The port's calibrated routing (``pilosa_tpu_torch.parallel.costmodel``
and the executor's two gates) against the JAX package.

- ``CostModel.device_pays`` and ``predict`` over a grid of sizes for one
  fixed ``Calibration``: the same decisions and the same predicted
  seconds in both packages (the port's ``device_bps`` set to the JAX
  package's ``DEVICE_BPS`` constant, which the port does not carry);
- the drift loop: the same scale corrections for the same seeded
  (predicted, actual) stream;
- an executor with an injected model that vetoes every device leg, and
  one that vetoes none, both give the JAX executor's answers for Count,
  Sum, TopN, a fused batch and a field Range; vetoes are counted; a
  cold leg is admitted at its second sighting;
- the static floor ``mesh_min_slices`` sends narrow calls to the host
  leg with the same answers;
- persistence reads only the directory it is given.
"""

import json

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.parallel import costmodel as jax_costmodel

from pilosa_tpu_torch import SLICE_WIDTH, carry
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.frame import Field
from pilosa_tpu_torch.parallel import costmodel, residency

N_SLICES = 4

CAL = dict(sync_s=2.0e-4, host_bps=3.0e9, upload_bps=1.2e9,
           pack_bps=4.0e8, host_scale=1.5, device_scale=0.75,
           stream_scale=2.0)


def _cals():
    jax_cal = jax_costmodel.Calibration(**CAL)
    port_cal = costmodel.Calibration(device_bps=jax_costmodel.DEVICE_BPS,
                                     **CAL)
    return jax_cal, port_cal


@pytest.mark.parametrize("margin", [0.0, 0.25, 0.5, 1.0, 4.0])
def test_device_pays_grid(margin):
    jax_cal, port_cal = _cals()
    jm = jax_costmodel.CostModel(jax_cal, margin)
    pm = costmodel.CostModel(port_cal, margin)
    sizes = [0, 1 << 10, 1 << 17, 1 << 20, 1 << 24, 1 << 28, 1 << 31]
    n = 0
    for total in sizes:
        for cold in (0, total // 2, total):
            for streaming in (False, True):
                for host in (None, total // 4, total * 3):
                    for crossings in (1, 3):
                        kw = dict(cold_bytes=cold, streaming=streaming,
                                  host_bytes=host, crossings=crossings)
                        assert pm.device_pays(total, **kw) == \
                            jm.device_pays(total, **kw), (total, kw)
                        n += 1
        for leg in ("host", "device", "device_stream"):
            assert pm.predict(leg, total, total // 3) == \
                jm.predict(leg, total, total // 3)
    assert n == len(sizes) * 36


def test_drift_loop():
    jax_cal, port_cal = _cals()
    jm = jax_costmodel.CostModel(jax_cal)
    pm = costmodel.CostModel(port_cal)
    rng = np.random.default_rng(7)
    for _ in range(80):
        leg = ("host", "device", "device_stream")[int(rng.integers(3))]
        pred = float(rng.uniform(1e-4, 1e-2))
        actual = pred * float(rng.choice([0.2, 1.0, 3.0, 9.0]))
        jm.record(leg, pred, actual)
        pm.record(leg, pred, actual)
    assert pm.drift_snapshot() == jm.drift_snapshot()
    assert pm.recalibrations == jm.recalibrations > 0


def test_calibration_round_trip_and_dir(tmp_path):
    cal = costmodel.Calibration(sync_s=1e-5, host_bps=2e9, upload_bps=3e9,
                                pack_bps=4e8, device_bps=2e12,
                                host_scale=2.0)
    assert costmodel.Calibration.from_dict(cal.to_dict()) == cal
    # Nothing persisted: the committed defaults, whatever is elsewhere.
    d = costmodel.default_calibration(str(tmp_path), "host-card")
    assert (d.sync_s, d.host_bps, d.device_bps) == (
        costmodel.DEFAULT_SYNC_S, costmodel.DEFAULT_HOST_BPS,
        costmodel.DEFAULT_DEVICE_BPS)
    assert costmodel.default_calibration() == d
    path = costmodel.cal_path(str(tmp_path), "host-card")
    model = costmodel.CostModel(cal, persist_path=path)
    for _ in range(costmodel.DRIFT_MIN_SAMPLES):
        model.record("host", 1e-3, 5e-3)  # host 5x slower than predicted
    assert model.recalibrations == 1
    with open(path) as f:
        assert json.load(f)["host_scale"] == pytest.approx(10.0)
    got = costmodel.default_calibration(str(tmp_path), "host-card")
    assert got.host_scale == pytest.approx(10.0)
    assert costmodel.default_calibration(str(tmp_path), "other").host_scale \
        == 1.0


def test_pinned_models():
    total = 1 << 20
    assert costmodel.pinned(0.0).device_pays(total, cold_bytes=total)
    assert not costmodel.pinned(float("inf")).device_pays(total)


# -- the executor's gates ----------------------------------------------------

def export_state(holder) -> dict:
    return {(frag.index, frag.frame, frag.view, frag.slice):
            frag.storage.all_positions()
            for frag in holder.iter_fragments()}


def _fill(holder, rng):
    from pilosa_tpu.models.frame import Field
    idx = holder.create_index("d")
    f = idx.create_frame("f")
    for row in range(6):
        cols = rng.choice(N_SLICES * SLICE_WIDTH, size=3000, replace=False)
        f.import_bits(np.full(len(cols), row, np.uint64),
                      cols.astype(np.uint64))
    b = idx.create_frame("b")
    b.create_field(Field(name="v", min=-100, max=1000))
    cols = rng.choice(N_SLICES * SLICE_WIDTH, size=500, replace=False)
    vals = rng.integers(-100, 1001, size=len(cols))
    b.import_field_values("v", cols.astype(np.uint64),
                          vals.astype(np.int64))


QUERIES = [
    "Count(Intersect(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f)))",
    "Count(Union(Bitmap(rowID=2, frame=f), Bitmap(rowID=3, frame=f)))",
    "Count(Bitmap(rowID=0, frame=f)) Count(Bitmap(rowID=4, frame=f))"
    " TopN(Bitmap(rowID=5, frame=f), frame=f, ids=[0, 1, 2, 3])",
    "TopN(Bitmap(rowID=1, frame=f), frame=f, n=3, ids=[0, 2, 3, 4, 5])",
    "TopN(frame=f, n=2)",
    "Sum(frame=b, field=v)",
    "Sum(Bitmap(rowID=0, frame=f), frame=b, field=v)",
    "Count(Range(frame=b, v > 300))",
    "Range(frame=b, v < 0)",
    "Union(" + ", ".join(f"Bitmap(rowID={r % 6}, frame=f)"
                         for r in range(9)) + ")",
]


def _norm(results):
    out = []
    for r in results:
        if hasattr(r, "bits"):
            out.append([int(x) for x in r.bits()])
        elif isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        elif hasattr(r, "value"):
            out.append((r.value, r.count))
        else:
            out.append(r)
    return out


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    _fill(jh, np.random.default_rng(99))
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1,
                      result_cache_bits=-1)
    want = {q: _norm(jex.execute("d", q)) for q in QUERIES}
    jex.close()
    exported = export_state(jh)
    jh.close()
    th, _ = carry.holder_from_state(
        str(tmp_path_factory.mktemp("port")), exported, device="cpu",
        frame_options={("d", "b"): {"fields": [
            Field(name="v", min=-100, max=1000)]}})
    yield th, want
    th.close()
    residency.device_cache().clear()


@pytest.mark.parametrize("margin", [0.0, float("inf")])
def test_injected_model_answers(state, margin):
    th, want = state
    ex = Executor(th, device="cpu", mesh_min_slices=1,
                  cost_model=costmodel.pinned(margin))
    for q in QUERIES:
        assert _norm(ex.execute("d", q)) == want[q], (margin, q)
    if margin == 0.0:
        assert ex.cost_vetoes == 0
    else:
        # Count, Sum, TopN refetch and the batch each counted a veto.
        assert ex.cost_vetoes >= 8
    assert ex.planner.calibration is ex.cost_model.cal


def test_floor_sends_narrow_calls_to_the_host(state):
    th, want = state
    ex = Executor(th, device="cpu", mesh_min_slices=N_SLICES + 1)
    for q in QUERIES:
        assert _norm(ex.execute("d", q)) == want[q], q
    assert ex.cost_vetoes == 0  # the floor is no veto


def test_cpu_executor_has_no_model(state):
    th, _ = state
    ex = Executor(th, device="cpu")
    ex.execute("d", QUERIES[0])
    assert ex.cost_model is None and ex.cost_vetoes == 0
    assert ex.mesh_min_slices == Executor.MESH_MIN_SLICES


def test_cold_leg_admitted_at_second_sighting(state):
    th, want = state
    residency.device_cache().clear()
    ex = Executor(th, device="cpu", mesh_min_slices=1,
                  cost_model=costmodel.pinned(float("inf")))
    # The planner's own placement (priced from the same constants)
    # would keep these narrow leaves on the host before the veto.
    ex.planner_enabled = False
    q = QUERIES[0]
    assert _norm(ex.execute("d", q)) == want[q]
    assert (ex.cost_vetoes, ex.cold_admits) == (1, 0)
    assert _norm(ex.execute("d", q)) == want[q]   # admitted: slabs built
    assert (ex.cost_vetoes, ex.cold_admits) == (1, 1)
    assert _norm(ex.execute("d", q)) == want[q]   # warm: the model decides
    assert ex.cost_vetoes == 2
