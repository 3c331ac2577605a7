"""The port's ray-query server (``repro_torch.serving``) held to the
contracts of the reference's ``tests/test_serving.py``.

* the **coalescer** and **admission control** are synchronous state
  machines, pinned with a fake clock: no sleeps, no event loop;
* the **server** is pinned to the hard contract: responses to coalesced
  concurrent requests are *bit-identical* (hits, indices, scores, job
  counters and ``rounds``) to calling ``QueryEngine`` directly per
  request, for every servable method; and a served ``trace`` and
  ``nearest`` agree with the reference engine's direct calls on the same
  seeded inputs (the reference's server is never started).

Each async test runs in its own ``asyncio.run`` and stops its server on
the way out.  An autouse fixture checks after every test that the
reference's telemetry switch, compile hook and snapshot sources are as
they were, and that the test left no non-daemon thread alive.
"""
import asyncio
import gc
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.api import PointCloudScene as JCloud
from repro.api import QueryEngine as JQueryEngine
from repro.api import Scene as JScene
from repro.core import make_ray as jmake_ray
from repro.serving.query_server import ServerStats as JServerStats
from repro_torch import obs
from repro_torch.api import PointCloudScene, QueryEngine, Scene, make_ray
from repro_torch.serving import (
    FLUSH_DEADLINE,
    FLUSH_FULL,
    FLUSH_TIMER,
    AdmissionController,
    Coalescer,
    QueryServer,
    QueueFull,
    RequestShed,
    ServerStats,
)
from repro_torch.serving.batching import Batch, make_request
from test_torch_models import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_trace import _assert_record

NEAREST = (("backend", None), ("k", 3), ("metric", "euclidean"))


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


# ---------------------------------------------------------------------------
# coalescer: fake-clock unit tests (no sleeps, no event loop)
# ---------------------------------------------------------------------------


def _req(method="trace", params=(("ray_type", "closest"),), rows=4, now=0.0,
         deadline=None):
    return make_request(method, params, torch.zeros((rows, 3)), rows, now,
                        deadline=deadline)


def test_coalescer_batch_full_flush():
    c = Coalescer(max_batch_rows=16, max_wait=10.0)
    assert c.add(_req(rows=6, now=0.0)) is None
    assert c.add(_req(rows=6, now=0.1)) is None
    batch = c.add(_req(rows=6, now=0.2))  # 18 >= 16: the bucket flushes
    assert batch is not None and batch.reason == FLUSH_FULL
    assert batch.rows == 18 and len(batch.requests) == 3
    assert batch.sizes == [6, 6, 6]
    assert c.depth == 0  # the flushed bucket is gone


def test_coalescer_oversized_request_flushes_alone():
    c = Coalescer(max_batch_rows=16, max_wait=10.0)
    batch = c.add(_req(rows=100, now=0.0))
    assert batch is not None and batch.reason == FLUSH_FULL
    assert batch.rows == 100 and len(batch.requests) == 1


def test_coalescer_timer_flush():
    c = Coalescer(max_batch_rows=1024, max_wait=5.0)
    c.add(_req(rows=4, now=0.0))
    c.add(_req(rows=4, now=3.0))
    assert c.poll(4.999) == []  # the oldest has waited 4.999 < 5
    assert c.next_due() == 5.0  # oldest (t=0) + max_wait
    [batch] = c.poll(5.0)
    assert batch.reason == FLUSH_TIMER and len(batch.requests) == 2
    assert c.poll(100.0) == [] and c.next_due() is None


def test_coalescer_deadline_pressure_flush():
    """A tight deadline overrides the (much longer) max-wait timer."""
    c = Coalescer(max_batch_rows=1024, max_wait=60.0, deadline_margin=1.0)
    c.add(_req(rows=4, now=0.0))
    c.add(_req(rows=4, now=0.0, deadline=5.0))  # earliest deadline t=5
    assert c.next_due() == 4.0  # deadline - margin, not oldest + max_wait
    assert c.poll(3.999) == []
    [batch] = c.poll(4.0)
    assert batch.reason == FLUSH_DEADLINE and len(batch.requests) == 2
    assert c.depth == 0


def test_coalescer_buckets_split_by_method_and_params():
    c = Coalescer(max_batch_rows=1024, max_wait=5.0)
    c.add(_req(params=(("ray_type", "closest"),), now=0.0))
    c.add(_req(params=(("ray_type", "shadow"),), now=0.0))
    c.add(_req(method="nearest", params=(("k", 4),), now=0.0))
    assert c.depth == 3 and len(c._buckets) == 3
    assert c.depth_for("trace") == 2 and c.depth_for("nearest") == 1
    batches = c.poll(5.0)
    assert len(batches) == 3  # one batch per bucket, never mixed
    assert len({(b.method, b.params) for b in batches}) == 3


def test_coalescer_evict_oldest_sheds_across_buckets():
    c = Coalescer(max_batch_rows=1024, max_wait=60.0)
    r1 = _req(rows=4, now=1.0)
    r2 = _req(method="nearest", params=(("k", 8),), rows=4, now=0.5)
    r3 = _req(rows=4, now=2.0)
    for r in (r1, r2, r3):
        c.add(r)
    assert c.evict_oldest() is r2  # globally oldest, whatever the bucket
    assert c.depth == 2 and c.depth_for("nearest") == 0
    assert c.evict_oldest() is r1
    assert c.evict_oldest() is r3
    assert c.evict_oldest() is None  # nothing queued -> nothing sheddable


def test_coalescer_flush_all_drains():
    c = Coalescer(max_batch_rows=1024, max_wait=60.0)
    c.add(_req(now=0.0))
    c.add(_req(method="nearest", params=(("k", 2),), now=0.0))
    batches = c.flush_all()
    assert len(batches) == 2 and c.depth == 0
    assert all(b.reason == "drain" for b in batches)


def test_coalescer_validation():
    with pytest.raises(ValueError, match="max_batch_rows"):
        Coalescer(max_batch_rows=0)
    with pytest.raises(ValueError, match="max_wait"):
        Coalescer(max_wait=-1.0)
    with pytest.raises(ValueError, match="deadline_margin"):
        Coalescer(deadline_margin=-0.1)


# ---------------------------------------------------------------------------
# admission control: verdicts + accounting
# ---------------------------------------------------------------------------


def test_admission_block_policy():
    a = AdmissionController(2, policy="block")
    assert a.try_admit() == "admit" and a.try_admit() == "admit"
    assert a.try_admit() == "wait"  # full: the submitter must wait
    assert a.depth == 2 and not a.has_capacity
    a.release()
    assert a.has_capacity
    a.admit_after_wait()
    s = a.stats()
    assert (s.depth, s.admitted, s.blocked) == (2, 3, 1)


def test_admission_reject_policy():
    a = AdmissionController(1, policy="reject")
    assert a.try_admit() == "admit"
    assert a.try_admit() == "reject"
    assert a.stats().rejected == 1
    a.release()
    assert a.try_admit() == "admit"


def test_admission_shed_policy():
    a = AdmissionController(1, policy="shed")
    assert a.try_admit() == "admit"
    assert a.try_admit() == "shed"
    a.admit_after_shed()  # the victim's slot transfers: depth unchanged
    s = a.stats()
    assert (s.depth, s.admitted, s.shed) == (1, 2, 1)
    a.shed_failed()  # nothing sheddable -> counted as a rejection
    assert a.stats().rejected == 1


def test_admission_validation():
    with pytest.raises(ValueError, match="limit"):
        AdmissionController(0)
    with pytest.raises(ValueError, match="policy"):
        AdmissionController(4, policy="drop")
    a = AdmissionController(2)
    with pytest.raises(ValueError, match="release"):
        a.release(1)  # nothing admitted yet


# ---------------------------------------------------------------------------
# the server: coalesced == per-request, bit for bit
# ---------------------------------------------------------------------------


def _data():
    rng = np.random.default_rng(11)
    n_tri = 150
    ctr = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    d1 = rng.normal(scale=0.12, size=(n_tri, 3)).astype(np.float32)
    d2 = rng.normal(scale=0.12, size=(n_tri, 3)).astype(np.float32)
    return (np.stack([ctr, ctr + d1, ctr + d2], 1),
            rng.normal(size=(400, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    """One engine over a triangle scene AND a point cloud, so a single
    server coalesces every servable method."""
    tris, pts = _data()
    return QueryEngine(scene=Scene.from_triangles(tris, device="cpu"),
                       cloud=PointCloudScene.from_points(pts, device="cpu"),
                       pad_multiple=8, shard=1)


def _ray_arrays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, -2, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return org, tgt - org


def _rays(n, seed):
    return make_ray(*_ray_arrays(n, seed), device="cpu")


def _queries(n, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32))


def _assert_bits(got, ref, msg=""):
    if isinstance(ref, torch.Tensor):
        got, ref = (got,), (ref,)
    assert len(got) == len(ref), msg
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, (msg, i)
        if r.is_floating_point():
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), (msg, i)


def test_server_mixed_methods_bitparity(engine):
    """Many small concurrent mixed-method requests, coalesced into shared
    batches, each response bit-identical to a direct engine call, job
    counters and per-request ``rounds`` included."""
    jobs = []  # (kind, payload, kwargs)
    for i in range(9):
        jobs.append(("trace", _rays(2 + i % 4, 50 + i),
                     dict(ray_type=("closest", "any", "shadow")[i % 3])))
    for i in range(4):
        jobs.append(("nearest", _queries(1 + i % 3, 80 + i), dict(k=5)))
        jobs.append(("nearest", _queries(2 + i % 2, 85 + i),
                     dict(k=4, backend="tree_wavefront")))
        jobs.append(("within", _queries(2 + i % 2, 90 + i), dict(radius=1.0, k=6)))
        jobs.append(("count_within", _queries(3, 70 + i), dict(radius=0.8)))
        jobs.append(("scores", _queries(1 + i % 2, 60 + i), dict(metric="angular")))

    async def serve():
        async with QueryServer(engine, max_batch_rows=64, max_wait=0.02) as server:
            tasks = [asyncio.ensure_future(getattr(server, kind)(payload, **kw))
                     for kind, payload, kw in jobs]
            return await asyncio.gather(*tasks), server.stats()

    results, stats = asyncio.run(serve())
    for (kind, payload, kw), got in zip(jobs, results):
        _assert_bits(got, getattr(engine, kind)(payload, **kw), f"{kind} {kw}")
    # coalescing demonstrably happened: fewer engine calls than requests
    assert stats["nearest"].requests_per_batch > 1
    assert stats["count_within"].requests_per_batch > 1
    assert sum(s.batches for s in stats.values()) < len(jobs)
    for s in stats.values():  # flush accounting is consistent
        assert s.flush_full + s.flush_timer + s.flush_deadline + s.flush_drain == s.batches
        assert s.queue_depth == 0
        assert 0.0 < s.mean_fill <= 1.0


def test_server_full_flush_and_param_buckets(engine):
    """Same-params requests share a batch (full-flush fires); different
    static params never mix."""
    async def serve():
        async with QueryServer(engine, max_batch_rows=8, max_wait=30.0) as server:
            # 4 + 4 rows of k=5 fill the 8-row bucket: a full flush, no
            # timer needed despite the 30 s max_wait
            t1 = asyncio.ensure_future(server.nearest(_queries(4, 1), k=5))
            t2 = asyncio.ensure_future(server.nearest(_queries(4, 2), k=5))
            r1, r2 = await asyncio.gather(t1, t2)
            # another k -> another bucket, flushed only by the drain
            t3 = asyncio.ensure_future(server.nearest(_queries(4, 3), k=3))
            await asyncio.sleep(0)
            await server.drain()
            return (r1, r2, await t3), server.stats()

    (r1, r2, r3), stats = asyncio.run(serve())
    for res, seed, k in ((r1, 1, 5), (r2, 2, 5), (r3, 3, 3)):
        _assert_bits(res, engine.nearest(_queries(4, seed), k=k))
    s = stats["nearest"]
    assert s.flush_full >= 1 and s.flush_drain >= 1
    assert s.requests == 3 and s.batches == 2


def test_server_deadline_triggers_early_flush(engine):
    """A request deadline flushes the bucket long before max_wait."""
    async def serve():
        async with QueryServer(engine, max_batch_rows=1024, max_wait=30.0,
                               deadline_margin=0.001) as server:
            res = await asyncio.wait_for(
                server.nearest(_queries(3, 7), k=4, timeout=0.01),
                timeout=10.0)  # must NOT take the 30 s timer path
            return res, server.stats()

    res, stats = asyncio.run(serve())
    _assert_bits(res, engine.nearest(_queries(3, 7), k=4))
    assert stats["nearest"].flush_deadline == 1


@pytest.mark.parametrize("policy", ["reject", "shed"])
def test_server_overload_policies(engine, policy):
    """At the limit, "reject" fast-fails the newcomer with QueueFull;
    "shed" drops the oldest queued request (its future fails with
    RequestShed) and the newcomer takes its slot."""
    async def serve():
        async with QueryServer(engine, max_batch_rows=1024, max_wait=30.0,
                               queue_limit=2, policy=policy) as server:
            f1 = await server.enqueue("nearest", _queries(2, 1), NEAREST)
            f2 = await server.enqueue("nearest", _queries(2, 2), NEAREST)
            if policy == "reject":
                with pytest.raises(QueueFull):
                    await server.nearest(_queries(2, 3), k=3)
                served = (f1, f2)
            else:
                f3 = await server.enqueue("nearest", _queries(2, 3), NEAREST)
                with pytest.raises(RequestShed):
                    await f1  # the oldest was the victim
                served = (f2, f3)
            await server.drain()
            return await asyncio.gather(*served), server.stats(), server.admission_stats()

    results, stats, adm = asyncio.run(serve())
    seeds = (1, 2) if policy == "reject" else (2, 3)
    for res, seed in zip(results, seeds):
        _assert_bits(res, engine.nearest(_queries(2, seed), k=3))
    if policy == "reject":
        assert adm.rejected == 1 and adm.shed == 0
    else:
        assert adm.shed == 1 and stats["nearest"].shed == 1
    assert adm.depth == 0


@pytest.mark.parametrize("method", ["trace", "nearest", "count_within"])
def test_server_empty_request_short_circuits(engine, method):
    async def serve():
        async with QueryServer(engine) as server:
            if method == "trace":
                return await server.trace(_rays(0, 0))
            if method == "nearest":
                return await server.nearest(_queries(0, 0), k=4)
            return await server.count_within(_queries(0, 0), 0.5)

    res = asyncio.run(serve())
    if method == "trace":
        assert res.t.shape == (0,) and int(res.rounds) == 0
    elif method == "nearest":
        assert res.indices.shape == (0, 4)
    else:
        assert res.shape == (0,)


def test_server_rejects_bad_requests_eagerly(engine):
    """Malformed static params, and tensors on another device than the
    engine's, fail in the submitter, before they can poison a batch."""
    async def serve():
        async with QueryServer(engine) as server:
            with pytest.raises(ValueError, match="ray_type"):
                await server.trace(_rays(2, 0), ray_type="laser")
            with pytest.raises(ValueError, match="k must be"):
                await server.nearest(_queries(2, 0), k=0)
            with pytest.raises(ValueError, match="radius"):
                await server.within(_queries(2, 0), radius=float("nan"), k=3)
            with pytest.raises(ValueError, match="method"):
                await server.enqueue("explode", _queries(2, 0), ())
            with pytest.raises(ValueError, match="meta"):
                await server.nearest(_queries(2, 0).to("meta"), k=3)
            with pytest.raises(ValueError, match="meta"):
                await server.trace(type(_rays(2, 0))(*(x.to("meta") for x in _rays(2, 0))))
            assert server.admission_stats().admitted == 0

    asyncio.run(serve())


def test_server_not_running_raises(engine):
    server = QueryServer(engine)

    async def go():
        with pytest.raises(RuntimeError, match="not running"):
            await server.trace(_rays(2, 0))

    asyncio.run(go())


def test_server_quantized_batches_compile_nothing_new(engine):
    """The power-of-two row ladder: batches whose row counts differ only
    within a ladder step reuse the engine's key (no new entry, no compile
    event)."""
    eng = QueryEngine(scene=engine.scene, cloud=engine.cloud, pad_multiple=8, shard=1)

    async def serve():
        async with QueryServer(eng, max_batch_rows=64, max_wait=0.005) as server:
            await server.nearest(_queries(9, 1), k=4)  # pads to the 16-ladder
            before = eng.cache_info().entries
            with obs.CompileTracker() as tracker:
                await server.nearest(_queries(12, 2), k=4)  # the same 16-ladder
                await server.nearest(_queries(15, 3), k=4)
            return before, eng.cache_info(), tracker.compiles

    before, after, compiles = asyncio.run(serve())
    assert after.entries == before and after.hits >= 2
    assert compiles == 0


@pytest.mark.parametrize("chunk,rows,target", [
    (None, 9, 16), (None, 100, 128), (None, 129, 256),  # the ladder step
    (16, 9, 16), (16, 20, 32), (16, 40, 48), (16, 100, 112),  # whole chunks past it
])
def test_server_pads_to_the_ladder_then_to_whole_chunks(engine, chunk, rows, target):
    """A batch pads to its ladder step's plan; past the engine's
    ``chunk_size`` only to whole chunks, which reuse one engine key."""
    eng = QueryEngine(scene=engine.scene, cloud=engine.cloud, pad_multiple=8, shard=1,
                      chunk_size=chunk)
    server = QueryServer(eng)
    batch = Batch("nearest", NEAREST, (), rows, FLUSH_FULL)
    assert server._target_rows(batch) == target
    ladder = eng.plan_for("nearest", 1 << (rows - 1).bit_length())
    assert eng.plan_for("nearest", target).key == ladder.key


# ---------------------------------------------------------------------------
# telemetry through the server
# ---------------------------------------------------------------------------


def test_server_stats_fields_are_the_references():
    assert ServerStats._fields == JServerStats._fields


def test_serving_span_chains_consistent(engine, tmp_path):
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    obs.default_buffer().clear()
    try:
        async def drive():
            async with QueryServer(engine, max_batch_rows=32, max_wait=2e-3) as server:
                qs = [_queries(3, 40 + i) for i in range(6)]
                await asyncio.gather(*[server.nearest(q, k=4) for q in qs])
                return server.stats()

        stats = asyncio.run(drive())
        path = tmp_path / "trace.json"
        obs.export_chrome_trace(str(path))
    finally:
        reg.enabled = was
    obs.default_buffer().clear()
    assert stats["nearest"].requests == 6
    chains: dict = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev["cat"] == "serving":
            chains.setdefault(ev["tid"], {})[ev["name"]] = ev
    assert len(chains) == 6
    for tid, evs in chains.items():
        assert set(evs) == {"admit", "coalesce", "execute", "split"}, tid
        # each phase starts no earlier than the previous one ended (1 us
        # of slack for the integer-microsecond rounding)
        assert evs["admit"]["ts"] <= evs["coalesce"]["ts"] + 1
        assert evs["coalesce"]["ts"] + evs["coalesce"]["dur"] <= evs["execute"]["ts"] + 1
        assert evs["execute"]["ts"] + evs["execute"]["dur"] <= evs["split"]["ts"] + 1
        assert all(e["dur"] >= 0 for e in evs.values())


def test_server_counts_with_global_telemetry_off(engine):
    """Serving accounting keeps exact counts with the global registry off
    (its registry is private and always on), and the server is a weakly
    held source of the port's snapshot."""
    assert not obs.is_enabled()
    spans = len(obs.default_buffer())

    async def drive(box):
        async with QueryServer(engine, max_batch_rows=32, max_wait=2e-3) as server:
            box.append(server)
            qs = [_queries(2, 20 + i) for i in range(4)]
            await asyncio.gather(*[server.nearest(q, k=4) for q in qs])
            return server.stats()

    box: list = []
    s = asyncio.run(drive(box))["nearest"]
    assert s.requests == 4 and s.rows == 8
    assert s.batches >= 1 and s.requests_per_batch >= 1.0
    assert s.p50_ms <= s.p99_ms
    assert len(obs.default_buffer()) == spans  # no spans while off
    snap = obs.snapshot()
    name = box[0]._source_name
    section = snap["sources"][name]
    assert section["nearest"]["requests"] == 4 and "admission" in section
    json.dumps(snap)  # the whole snapshot is strictly JSON
    box.clear()
    del section, snap
    gc.collect()
    assert name not in obs.snapshot()["sources"]


def test_port_telemetry_leaves_the_reference_untouched(engine):
    """The port's switch, compile tracker and server act on the port's
    plane only: the reference's switch, compile hook and sources stay as
    they were (the autouse fixture checks the same after every test)."""
    before = (ref_obs.is_enabled(), ref_obs.hook_installed(), dict(ref_obs._SOURCES))
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    try:
        async def drive():
            async with QueryServer(engine, max_batch_rows=16, max_wait=1e-3) as server:
                with obs.CompileTracker():
                    return await server.count_within(_queries(3, 5), 0.5), server

        res, server = asyncio.run(drive())
        assert server._source_name in obs.snapshot()["sources"]
    finally:
        reg.enabled = was
    _assert_bits(res, engine.count_within(_queries(3, 5), 0.5))
    assert obs.hook_installed()
    assert (ref_obs.is_enabled(), ref_obs.hook_installed(), dict(ref_obs._SOURCES)) == before
    # not ``ref_obs.snapshot()``: it prunes the sources of servers that earlier
    # tests in this process left to be collected, which the guard compares
    assert not ref_obs.is_enabled()


# ---------------------------------------------------------------------------
# served results against the reference's engine
# ---------------------------------------------------------------------------


def test_served_trace_and_nearest_match_the_reference_engine(engine):
    """A served ``trace`` (closest and shadow) and ``nearest`` from the port
    on the CPU against the reference engine's direct calls on the same
    seeded inputs: trace fields exact but ``t``, held to the forward error
    bound of ``tests/test_torch_trace.py`` (the reference's XLA may
    contract FMAs); nearest indices exact, distances within 1e-5 of
    |q|^2 + |c|^2."""
    tris, pts = _data()
    ref = JQueryEngine(scene=JScene.from_triangles(tris), cloud=JCloud.from_points(pts),
                       pad_multiple=8, shard=1)
    trace_jobs = [(_ray_arrays(3 + i, 200 + i), ("closest", "shadow")[i % 2])
                  for i in range(4)]
    query_jobs = [_queries(2 + i, 300 + i) for i in range(3)]

    async def serve():
        async with QueryServer(engine, max_batch_rows=64, max_wait=0.01) as server:
            traces = [asyncio.ensure_future(server.trace(make_ray(*a, device="cpu"), rt))
                      for a, rt in trace_jobs]
            near = [asyncio.ensure_future(server.nearest(q, k=5)) for q in query_jobs]
            return await asyncio.gather(*traces), await asyncio.gather(*near)

    traces, nears = asyncio.run(serve())
    for ((org, d), ray_type), got in zip(trace_jobs, traces):
        want = ref.trace(jmake_ray(jnp.asarray(org), jnp.asarray(d)), ray_type,
                         backend="wavefront")
        _assert_record(got, want, ray_type, tris, make_ray(org, d, device="cpu"))
    for q, got in zip(query_jobs, nears):
        want = ref.nearest(jnp.asarray(q.numpy()), 5)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        idx = got.indices.numpy()
        q64 = q.numpy().astype(np.float64)
        scale = (q64**2).sum(1)[:, None] + (pts.astype(np.float64)[idx]**2).sum(-1)
        assert (np.abs(got.scores.numpy() - np.asarray(want.scores)) <= 1e-5 * scale).all()
