"""The port's telemetry plane (``repro_torch.obs``) held to the contracts
of the reference's ``tests/test_obs.py``.

* **Disabled is invisible.**  The default registry ships disabled;
  instruments mutate nothing while it is off, and engine results are
  bit-identical with telemetry on and off for every servable method.
* **Registry semantics.**  Same name -> same instrument; ``reset`` zeroes
  in place; a snapshot is JSON; a percentile is within one log2 bucket of
  the true order statistic.
* **Compile tracking.**  ``CompileTracker`` counts a kernel-library build
  that runs ``nvcc`` (a fake one here) and an engine key not seen before,
  and reads 0 over a warm engine.
* **Engine metrics.**  Cache hits and misses, real vs padded rows, chunk
  fan-out, calls per backend and job totals match the plan
  (``QueryEngine.plan_for``) and the result's own counters.
* **Trace export.**  The Chrome trace-event format, microseconds, and the
  buffer following the global switch.

The reference's process-global state (its switch, compile hook and
snapshot sources) is never touched here: an autouse fixture checks it
after every test, with the threads each test leaves behind.
"""
import json
import math
import threading
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro_torch import obs
from repro_torch.api import PointCloudScene, QueryEngine, Scene, VectorIndex, make_ray
from repro_torch.kernels import nvcc
from repro_torch.obs.metrics import HIST_BINS, MetricsRegistry
from repro_torch.obs.trace import TraceBuffer, annotate
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def reference_state_untouched():
    """The reference's telemetry switch, compile hook and snapshot sources,
    and the process's live non-daemon threads, as they were before the
    test."""
    before = (ref_obs.is_enabled(), ref_obs.hook_installed(), set(ref_obs._SOURCES))
    threads = set(threading.enumerate())
    yield
    assert (ref_obs.is_enabled(), ref_obs.hook_installed(), set(ref_obs._SOURCES)) == before
    left = [t for t in threading.enumerate()
            if t not in threads and t.is_alive() and not t.daemon]
    assert not left, left


@pytest.fixture
def telemetry():
    """The port's global plane on for one test, its prior switch restored
    after (the registry is process-global: tests measure deltas)."""
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    yield reg
    reg.enabled = was


def _counters():
    return dict(obs.snapshot()["counters"])


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, -2, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return make_ray(org, tgt - org, device="cpu")


def _queries(n, d, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    """One engine over a triangle scene and a point cloud (every servable
    method, brute and tree)."""
    rng = np.random.default_rng(7)
    ctr = rng.uniform(-1, 1, (80, 3)).astype(np.float32)
    tris = np.stack([ctr, ctr + rng.normal(scale=0.1, size=(80, 3)).astype(np.float32),
                     ctr + rng.normal(scale=0.1, size=(80, 3)).astype(np.float32)], 1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    return QueryEngine(scene=Scene.from_triangles(tris, device="cpu"),
                       cloud=PointCloudScene.from_points(pts, device="cpu"),
                       pad_multiple=8, shard=1)


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------


def test_registry_disabled_is_noop():
    reg = MetricsRegistry()  # disabled is the default
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    c.inc()
    c.inc(5)
    g.set(3.5)
    h.observe(1.0)
    assert c.value == 0 and g.value == 0.0 and h.count == 0
    reg.enable()
    c.inc(2)
    g.set(3.5)
    h.observe(1.0)
    assert c.value == 2 and g.value == 3.5 and h.count == 1
    reg.disable()
    c.inc()
    assert c.value == 2  # frozen again


def test_same_name_same_instrument_and_reset_keeps_identity():
    reg = MetricsRegistry(enabled=True)
    assert reg.counter("x") is reg.counter("x")
    assert reg.histogram("x") is reg.histogram("x")
    assert reg.gauge("x") is reg.gauge("x")
    c, h = reg.counter("c"), reg.histogram("h")
    c.inc(9)
    h.observe(2.0)
    reg.reset()
    assert c is reg.counter("c") and c.value == 0
    assert h.count == 0 and h.buckets == [0] * HIST_BINS
    c.inc()
    assert reg.counter("c").value == 1


def test_registry_snapshot_is_jsonable():
    reg = MetricsRegistry(enabled=True)
    reg.counter("a").inc(3)
    reg.gauge("b").set(1.5)
    reg.histogram("ms").observe(4.2)
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["counters"] == {"a": 3}
    assert snap["gauges"] == {"b": 1.5}
    assert snap["histograms"]["ms"]["count"] == 1
    reg.histogram("empty")  # empty histograms export None, not NaN
    s = reg.snapshot()["histograms"]["empty"]
    assert s["count"] == 0 and s["p50"] is None and s["min"] is None


def test_histogram_percentile_within_bucket_factor():
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("lat")
    vals = np.exp(np.random.default_rng(0).uniform(np.log(1e-3), np.log(1e3), 500))
    for v in vals:
        h.observe(float(v))
    for q in (0.1, 0.5, 0.9, 0.99):
        est, true = h.percentile(q), float(np.quantile(vals, q))
        assert true / 2 <= est <= true * 2, (q, est, true)
        assert h.min <= est <= h.max
    assert h.percentile(0.5) <= h.percentile(0.99)
    assert math.isclose(h.mean(), float(vals.mean()), rel_tol=1e-9)
    assert math.isnan(reg.histogram("none").percentile(0.5))


def test_global_snapshot_schema_and_weak_sources(tmp_path):
    class Source:
        def provide(self):
            return {"n": 1}

    src = Source()
    name = obs.register_source("obs-test", src.provide)
    assert obs.register_source("obs-test", src.provide) == name + "#2"
    snap = obs.snapshot()
    assert set(snap) == {"enabled", "jit", "counters", "gauges", "histograms",
                         "derived", "trace", "sources"}
    assert snap["sources"][name] == {"n": 1} and snap["sources"][name + "#2"] == {"n": 1}
    assert set(snap["jit"]) == {"hook_installed", "compiles"}
    obs.unregister_source(name)
    del src  # held weakly: a dropped provider leaves the snapshot
    assert not any(k.startswith("obs-test") for k in obs.snapshot()["sources"])
    path = tmp_path / "snap.json"
    written = obs.write_snapshot(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(written))
    from repro_torch.obs import dump
    assert dump.main([str(path)]) == 0


# ---------------------------------------------------------------------------
# compile tracking
# ---------------------------------------------------------------------------


def test_compile_tracker_counts_new_engine_keys_not_warm_ones():
    eng = VectorIndex.from_database(_queries(64, 16, 3), device="cpu").engine(
        pad_multiple=8, shard=1)
    q = _queries(12, 16, 4)
    with obs.CompileTracker() as cold:
        eng.nearest(q, 5)
    assert cold.available and obs.hook_installed()
    assert cold.compiles == 1  # one new key: ("nearest", "mxu", ...)
    with obs.CompileTracker() as warm:
        eng.nearest(q, 5)
        eng.nearest(q[:9], 5)  # 9 rows pad to the same 16-row block
    assert warm.compiles == 0
    assert obs.total_compiles() >= cold.compiles
    tracker = obs.CompileTracker()
    assert tracker.compiles == 0  # before its window opens
    tracker.start()
    eng.nearest(q, 6)  # another k: another key
    assert tracker.stop() == 1 and tracker.compiles == 1


def test_kernel_library_build_counts_when_nvcc_runs(tmp_path, monkeypatch):
    """A build that runs nvcc (a stand-in that writes each ``-o`` file)
    counts one compile event; finding the built library on disk counts
    none."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = -o ] && : > \"$2\"; "
                    "shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc, "build_log", {})
    with obs.CompileTracker() as first:
        lib = nvcc.build()
    assert lib.exists() and first.compiles == 1
    with obs.CompileTracker() as again:
        assert nvcc.build() == lib
    assert again.compiles == 0


# ---------------------------------------------------------------------------
# engine metrics + bit parity
# ---------------------------------------------------------------------------

#: every servable method, on the brute and the tree backends
ENGINE_CASES = [
    ("trace", None, {"ray_type": "closest"}),
    ("trace", None, {"ray_type": "shadow"}),
    ("trace", None, {"backend": "per_ray"}),
    ("nearest", 3, {"k": 5}),
    ("nearest", 3, {"k": 5, "backend": "tree_wavefront"}),
    ("nearest", 3, {"k": 4, "metric": "cosine"}),
    ("within", 3, {"radius": 0.6, "k": 6}),
    ("within", 3, {"radius": 0.6, "k": 6, "backend": "tree_wavefront"}),
    ("count_within", 3, {"radius": 0.8}),
    ("count_within", 3, {"radius": 0.8, "backend": "tree_wavefront"}),
    ("scores", 3, {"metric": "angular"}),
]


@pytest.mark.parametrize("method,dim,kw", ENGINE_CASES,
                         ids=[f"{m}-{'-'.join(map(str, kw.values()))}"
                              for m, _, kw in ENGINE_CASES])
def test_engine_results_bit_identical_telemetry_on_off(engine, telemetry, method, dim, kw):
    payload = _rays(13) if method == "trace" else _queries(13, dim, 5)
    obs.disable()
    off = getattr(engine, method)(payload, **kw)
    obs.enable()
    on = getattr(engine, method)(payload, **kw)
    obs.disable()
    off2 = getattr(engine, method)(payload, **kw)
    if isinstance(off, torch.Tensor):
        off, on, off2 = (off,), (on,), (off2,)
    for a, b, c in zip(off, on, off2):
        assert torch.equal(a, b) and torch.equal(b, c)
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_engine_metrics_pinned_against_plan(telemetry):
    eng = VectorIndex.from_database(_queries(64, 16, 3), device="cpu").engine(
        pad_multiple=8, shard=1)
    q = _queries(12, 16, 4)
    plan = eng.plan_for("nearest", 12)
    assert (plan.block, plan.n_blocks) == (16, 1)
    before = _counters()
    eng.nearest(q, 5)
    eng.nearest(q, 5)  # second call: a cache hit, the same plan
    after = _counters()

    def delta(key):
        return after.get(key, 0) - before.get(key, 0)

    assert delta("engine.cache.misses") == 1
    assert delta("engine.cache.hits") == 1
    assert delta("engine.rows.real") == 2 * plan.n
    assert delta("engine.rows.padded") == 2 * plan.block * plan.n_blocks
    assert delta("engine.chunks") == 2 * plan.n_blocks
    assert delta("engine.calls.nearest.mxu") == 2
    assert obs.snapshot()["gauges"]["engine.shards"] == plan.shards
    hist = obs.snapshot()["histograms"]["engine.call_ms.nearest"]
    assert hist["count"] >= 2 and hist["min"] >= 0.0
    # chunked: 12 rows in blocks of 8
    before = _counters()
    eng.nearest(q, 5, chunk_size=8)
    after = _counters()
    chunked = eng.plan_for("nearest", 12, chunk_size=8)
    assert delta("engine.chunks") == chunked.n_blocks == 2
    assert delta("engine.rows.padded") == chunked.block * chunked.n_blocks
    # the derived block agrees with the snapshot's own counters
    snap = obs.snapshot()
    c = snap["counters"]
    real, padded = c["engine.rows.real"], c["engine.rows.padded"]
    assert snap["derived"]["pad_waste_fraction"] == pytest.approx(1.0 - real / padded)
    hits, misses = c["engine.cache.hits"], c["engine.cache.misses"]
    assert snap["derived"]["cache_hit_rate"] == pytest.approx(hits / (hits + misses))


@pytest.mark.parametrize("method", ["trace", "tree"])
def test_engine_job_counters_match_result(engine, telemetry, method):
    before = _counters()
    if method == "trace":
        res = engine.trace(_rays(10, seed=4), backend="wavefront")
        jobs = {"quadbox": res.quadbox_jobs, "triangle": res.triangle_jobs}
        backend = "wavefront"
    else:
        res = engine.neighbor_search(_queries(10, 3, 6), 4, 0.7,
                                     backend="tree_wavefront")
        jobs = {"box": res.box_jobs, "point": res.point_jobs}
        backend = "tree_wavefront"
    after = _counters()
    for name, per_row in jobs.items():
        key = f"engine.jobs.{name}.{backend}"
        assert after[key] - before.get(key, 0) == int(per_row.sum())
        assert int(per_row.sum()) > 0


def test_engine_records_nothing_while_disabled(engine):
    assert not obs.is_enabled()  # the process default
    before = (_counters(), obs.snapshot()["histograms"], len(obs.default_buffer()))
    engine.trace(_rays(9, seed=5))
    engine.nearest(_queries(5, 3, 6), 3)
    assert (_counters(), obs.snapshot()["histograms"], len(obs.default_buffer())) == before


# ---------------------------------------------------------------------------
# trace spans + Chrome export
# ---------------------------------------------------------------------------


def test_chrome_trace_export_format(tmp_path):
    buf = TraceBuffer(enabled=True)
    buf.record("admit", 1.0, 0.25, tid=42, cat="serving", args={"rows": 3})
    buf.record("execute", 1.25, 0.5, tid=42, cat="serving")
    path = tmp_path / "trace.json"
    assert buf.export_chrome_trace(str(path)) == 2
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    ev = doc["traceEvents"][0]
    assert ev == {"name": "admit", "cat": "serving", "ph": "X", "ts": 1_000_000,
                  "dur": 250_000, "pid": 0, "tid": 42, "args": {"rows": 3}}
    e2 = doc["traceEvents"][1]
    assert e2["ts"] == ev["ts"] + ev["dur"]  # seconds -> integer us
    small = TraceBuffer(enabled=True, max_spans=2)
    for i in range(3):
        small.record(str(i), float(i), 0.0)
    assert [s.name for s in small.spans()] == ["1", "2"]  # oldest dropped


def test_trace_buffer_and_annotate_follow_global_switch(telemetry):
    buf = TraceBuffer()  # enabled=None: follows the default registry
    obs.disable()
    buf.record("x", 0.0, 1.0)
    assert len(buf) == 0
    assert isinstance(annotate("engine.trace"), nullcontext)
    obs.enable()
    buf.record("x", 0.0, 1.0)
    assert len(buf) == 1
    scope = annotate("engine.trace")
    assert isinstance(scope, torch.profiler.record_function)
    with scope:  # a no-op scope with no profiler active
        pass
