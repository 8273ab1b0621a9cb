"""Streaming (`prepare_streaming`, `extend`, `retire` and a refit over the
live rows) in the port against the JAX package, on the CPU.

  * The same history and seed give the JAX package's stream artifacts bit
    for bit on the device backend: scale, capacity, rows, live mask,
    generation, rebuilds, codes, keys, scaled points, `w0` and the coarse
    heap, after every step of a history that extends in the domain, grows
    the capacity past 1,024 rows, retires and extends out of the domain.
  * The cpu backend opens the JAX package's indices, with its extras, for
    the same history and seeds; the masked cost agrees to rtol 1e-5.
  * The law (Philox cannot replay threefry): the streaming section of
    `tests/test_conformance.py`, its fixture, history and thresholds, on
    both of the port's backends.
  * The contracts of `tests/test_streaming.py` against the port: scratch
    equivalence (property-style), the extend-then-retire round trip bit
    for bit, retire id validation, `forget` of an extended stream, the
    cache re-keying, `prepare_data` never hitting a mutated stream and a
    refit after extend drawing from the grown stream.
  * The drift layer equals the JAX package's: `DriftDetector`,
    `MiniBatchRefiner`, `split_merge_k` and, on the cpu backend,
    `StreamingController` over a drifting stream.
  * The base weights `w0`: the lane-batched seeders start from them as
    from the `n_real` mask when they are that mask, a lane-batched solve
    over them equals its one-lane solves, and with every weight at 0 the
    draws stay on the live rows.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_conformance as conf
from repro.core import ClusterPlan as JaxClusterPlan
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import ExecutionSpec as JaxExecutionSpec
from repro.core import streaming as jstreaming
from repro_torch.core import (
    ClusterPlan,
    ClusterSpec,
    DriftDetector,
    DriftPolicy,
    ExecutionSpec,
    MiniBatchRefiner,
    StreamingController,
    no_retrace,
    split_merge_k,
)
from repro_torch.core import device_seeding as ds

D = 3
OPTIONS = {"lsh_r": 1e6, "resolution": 0.05}
BACKENDS = ["cpu", "device"]
SEEDERS = ["rejection", "fastkmeans++"]
TENSORS = ["codes_lo", "codes_hi", "keys_lo", "keys_hi", "pts_scaled", "w0",
           "base_heap"]


def _spec(k=2, seeder="rejection", seed=0, cls=ClusterSpec):
    return cls(k=k, seeder=seeder, c=1.2, quantize=False, seed=seed,
               options=OPTIONS)


def _plan(backend, **spec_kw) -> ClusterPlan:
    return ClusterPlan(_spec(**spec_kw),
                       ExecutionSpec(backend=backend, device="cpu"))


def _jax_plan(backend, **spec_kw) -> JaxClusterPlan:
    return JaxClusterPlan(_spec(cls=JaxClusterSpec, **spec_kw),
                          JaxExecutionSpec(backend=backend))


def _points(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, D)) * 3.0


def _history(seed: int):
    """(prepare rows, [(step, payload), ...]): an extend inside the frozen
    domain (midpoints of prepared rows), an extend that grows the capacity
    past 1,024 rows, a retire of rows of all three, and an extend outside
    the domain."""
    pts = _points(seed, 120)
    rng = np.random.default_rng(seed + 1)
    pairs = rng.integers(0, 120, size=(2, 40))
    inside = 0.5 * (pts[pairs[0]] + pts[pairs[1]])
    grow = pts[rng.integers(0, 120, size=1000)]
    retired = rng.choice(1160, size=300, replace=False)
    return pts, [("extend", inside), ("extend", grow), ("retire", retired),
                 ("extend", pts[:5] * 40.0)]


def _run_history(plan, seed: int, after_each=None):
    first, steps = _history(seed)
    prep = plan.prepare_streaming(first)
    if after_each is not None:
        after_each(prep)
    for step, payload in steps:
        getattr(plan, step)(payload, prepared=prep)
        if after_each is not None:
            after_each(prep)
    return prep


def _same_host_state(mine, theirs) -> None:
    for name in ("scale", "capacity", "n_rows", "generation", "rebuilds",
                 "reseed_root"):
        assert getattr(mine, name) == getattr(theirs, name), name
    np.testing.assert_array_equal(mine.live, theirs.live)
    np.testing.assert_array_equal(mine.host_scaled, theirs.host_scaled)


# -- the stream artifacts against the JAX package ------------------------------

@pytest.mark.parametrize("seeder", SEEDERS)
def test_stream_artifacts_match_jax_package(seeder):
    mine, theirs = [], []
    _run_history(_plan("device", seeder=seeder), 3,
                 lambda p: mine.append(_snapshot(p.streaming)))
    _run_history(_jax_plan("device", seeder=seeder), 3,
                 lambda p: theirs.append(_snapshot(p.streaming)))
    assert len(mine) == len(theirs) == 5
    for step, (a, b) in enumerate(zip(mine, theirs)):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{name} at step {step}")
    assert [s["capacity"] for s in mine] == [1024, 1024, 2048, 2048, 2048]
    assert [s["rebuilds"] for s in mine] == [0, 0, 0, 0, 1]
    assert (seeder == "rejection") == ("keys_lo" in mine[0])


def _snapshot(state) -> dict:
    """Host copies of a stream's fields (its tensors as NumPy arrays)."""
    out = {name: np.array(getattr(state, name))
           for name in ("scale", "capacity", "n_rows", "generation",
                        "rebuilds", "live", "host_scaled")}
    for name in TENSORS:
        value = getattr(state, name)
        if value is not None:
            out[name] = np.array(value.numpy() if isinstance(
                value, torch.Tensor) else np.asarray(value))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("seeder", SEEDERS)
def test_cpu_stream_fit_matches_jax_package(seeder, seed):
    k = 6
    mine = _run_history(_plan("cpu", seeder=seeder, k=k, seed=seed), seed)
    theirs = _run_history(_jax_plan("cpu", seeder=seeder, k=k, seed=seed),
                          seed)
    _same_host_state(mine.streaming, theirs.streaming)
    for fit_seed in (None, seed + 11):
        res = _plan("cpu", seeder=seeder, k=k, seed=seed).fit_prepared(
            mine, seed=fit_seed)
        jres = _jax_plan("cpu", seeder=seeder, k=k, seed=seed).fit_prepared(
            theirs, seed=fit_seed)
        np.testing.assert_array_equal(res.indices.numpy(),
                                      np.asarray(jres.indices))
        assert set(res.extras) == set(jres.extras)
        for key, value in jres.extras.items():
            np.testing.assert_array_equal(np.asarray(res.extras[key]),
                                          np.asarray(value), err_msg=key)
        np.testing.assert_allclose(float(res.cost), float(jres.cost),
                                   rtol=1e-5)
        assert np.isin(res.indices.numpy(),
                       mine.streaming.live_ids()).all()


def test_masked_cost_counts_only_live_rows():
    plan = _plan("device", k=4)
    prep = _run_history(plan, 5)
    res = plan.fit_prepared(prep, seed=2)
    live = prep.streaming.live_points()
    ctr = prep.streaming.host_pts[res.indices.numpy()]
    d2 = ((live[:, None, :] - ctr[None]) ** 2).sum(-1).min(axis=1)
    assert float(res.cost) == pytest.approx(d2.sum(), rel=1e-5)
    assert res.centers.dtype == torch.float32
    assert prep.points_dev.shape[0] == prep.streaming.n_rows


# -- the law over a mutated stream ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _stream_draws(backend: str) -> np.ndarray:
    """`tests/test_conformance.py:_stream_draws` against the port: prepare
    rows 0..63, extend 64..95, extend 1,024 duplicates (past the 1,024-row
    capacity rung), retire every duplicate, then R seeded refits."""
    pts = conf._fixture()
    kw = conf.SEEDER_KW
    plan = ClusterPlan(
        ClusterSpec(k=2, seeder="rejection", c=kw["c"], quantize=False,
                    seed=0, options={"lsh_r": kw["lsh_r"],
                                     "resolution": kw["resolution"]}),
        ExecutionSpec(backend=backend, device="cpu"))
    prep = plan.prepare_streaming(pts[:64])
    plan.extend(pts[64:], prepared=prep)
    dup = pts[np.random.default_rng(777).integers(0, conf.N, size=1024)]
    plan.extend(dup, prepared=prep)
    plan.retire(np.arange(conf.N, conf.N + 1024), prepared=prep)
    assert prep.streaming.live_count == conf.N
    assert prep.streaming.capacity == 2048
    np.testing.assert_array_equal(prep.streaming.live_ids(),
                                  np.arange(conf.N))
    out = np.empty((conf.R, 2), dtype=np.int64)
    with no_retrace():
        for s in range(conf.R):
            res = plan.fit_prepared(prep, seed=10_000 + s)
            out[s] = res.indices.numpy()
    plan.forget(prep)
    assert (out >= 0).all() and (out < conf.N).all()  # retired never drawn
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_first_center_uniform(backend):
    uniform, _ = conf._exact_laws(conf._fixture())
    assignment = conf._mass_balanced_bins(uniform, conf.BINS)
    draws = _stream_draws(backend)
    counts = conf._binned(np.bincount(draws[:, 0], minlength=conf.N)
                          .astype(float), assignment, conf.BINS)
    expected = conf._binned(uniform, assignment, conf.BINS) * conf.R
    stat = conf._chi2_stat(counts, expected)
    crit = conf._chi2_isf(conf.ALPHA / conf.N_TESTS, conf.BINS - 1)
    assert stat < crit, (backend, stat, crit)


@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_second_center_exact_d2(backend):
    _, marg2 = conf._exact_laws(conf._fixture())
    assignment = conf._mass_balanced_bins(marg2, conf.BINS)
    draws = _stream_draws(backend)
    counts = conf._binned(np.bincount(draws[:, 1], minlength=conf.N)
                          .astype(float), assignment, conf.BINS)
    expected = conf._binned(marg2, assignment, conf.BINS) * conf.R
    stat = conf._chi2_stat(counts, expected)
    crit = conf._chi2_isf(conf.ALPHA / conf.N_TESTS, conf.BINS - 1)
    assert stat < crit, (backend, stat, crit)
    tv = 0.5 * np.abs(counts / conf.R - expected / conf.R).sum()
    assert tv < conf.TV_BOUND, (backend, tv)


# -- the contracts of tests/test_streaming.py ------------------------------------

@settings(max_examples=5, deadline=None)
@given(st.integers(0, 1), st.integers(8, 32), st.integers(1, 12),
       st.integers(0, 10_000))
def test_extend_duplicates_matches_scratch(backend_i, n_a, n_b, seed):
    """prepare_streaming(A); extend(B) == prepare_streaming(A + B) when B
    duplicates rows of A: the same frozen geometry, the same artifacts and
    the same seeded draws."""
    backend = BACKENDS[backend_i]
    pts_a = _points(seed, n_a)
    pts_b = pts_a[np.random.default_rng(seed + 1).integers(0, n_a, size=n_b)]
    plan = _plan(backend)
    inc = plan.prepare_streaming(pts_a)
    plan.extend(pts_b, prepared=inc)
    scratch = plan.prepare_streaming(np.concatenate([pts_a, pts_b]))
    si, ss = inc.streaming, scratch.streaming
    assert si.n_rows == ss.n_rows == n_a + n_b
    assert si.rebuilds == 0            # duplicates never leave the domain
    assert (si.generation, ss.generation) == (1, 0)
    assert (si.scale, si.capacity, si.reseed_root) == \
        (ss.scale, ss.capacity, ss.reseed_root)
    np.testing.assert_array_equal(si.live, ss.live)
    np.testing.assert_array_equal(si.host_scaled, ss.host_scaled)
    if backend == "device":
        for name in TENSORS:
            assert torch.equal(getattr(si, name), getattr(ss, name)), name
    ri = plan.fit_prepared(inc, seed=seed + 7)
    rs = plan.fit_prepared(scratch, seed=seed + 7)
    torch.testing.assert_close(ri.indices, rs.indices, rtol=0, atol=0)
    np.testing.assert_allclose(float(ri.cost), float(rs.cost), rtol=1e-6,
                               atol=0.0)
    plan.forget(inc)
    plan.forget(scratch)


@settings(max_examples=6, deadline=None)
@given(st.integers(4, 48), st.integers(1, 24), st.integers(0, 10_000))
def test_extend_then_retire_roundtrips_weights(n_a, n_b, seed):
    """Extend-then-retire of the same rows gives `w0` and `base_heap`
    back bit for bit on the device backend (weights patch to exactly 0)."""
    plan = _plan("device")
    prep = plan.prepare_streaming(_points(seed, n_a))
    state = prep.streaming
    w0_before = state.w0.clone()
    heap_before = state.base_heap.clone()
    plan.extend(_points(seed + 1, n_b), prepared=prep)
    plan.retire(np.arange(n_a, n_a + n_b), prepared=prep)
    assert state.live_count == n_a
    assert torch.equal(state.w0, w0_before)
    assert torch.equal(state.base_heap, heap_before)
    assert torch.equal(state.base_heap, state.ts.init(state.w0))
    plan.forget(prep)


@pytest.mark.parametrize("backend", BACKENDS)
def test_retire_validates_ids(backend):
    plan = _plan(backend)
    prep = plan.prepare_streaming(_points(0, 16))
    with pytest.raises(IndexError):
        plan.retire([16], prepared=prep)
    with pytest.raises(IndexError):
        plan.retire([-1], prepared=prep)
    plan.retire([3], prepared=prep)
    with pytest.raises(ValueError):
        plan.retire([3], prepared=prep)        # already retired
    assert prep.streaming.live_count == 15
    plan.forget(prep)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forget_releases_extended_stream(backend):
    plan = _plan(backend)
    prep = plan.prepare_streaming(_points(0, 24))
    plan.extend(_points(1, 8), prepared=prep)
    assert prep.fingerprint in plan._prepared
    assert plan.forget(prep) is True
    assert prep.fingerprint not in plan._prepared
    assert not plan._prepared                  # nothing else retained
    assert plan.forget(prep) is False          # idempotent


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutation_rekeys_cache_entry(backend):
    """After extend/retire the entry moves from its stale key to exactly
    one ``#g<generation>`` key; the handle's fingerprint tracks it."""
    plan = _plan(backend)
    prep = plan.prepare_streaming(_points(0, 24))
    key0 = prep.fingerprint
    assert "/stream0#g0" in key0
    plan.extend(_points(1, 8), prepared=prep)
    assert key0 not in plan._prepared
    assert prep.fingerprint.endswith(f"#g{prep.streaming.generation}")
    assert prep.generation == prep.streaming.generation == 1
    assert [k for k, v in plan._prepared.items() if v is prep] == \
        [prep.fingerprint]
    assert prep.points_dev is None
    plan.retire([0], prepared=prep)
    assert prep.fingerprint.endswith("#g2")
    assert len([k for k, v in plan._prepared.items() if v is prep]) == 1
    assert plan.cache_info()["extends"] == plan.cache_info()["retires"] == 1
    plan.forget(prep)


def test_prepare_data_never_hits_mutated_stream():
    """A fresh `prepare_data` of the original points is a new build: the
    mutated stream's entry can never alias a content-fingerprint hit."""
    plan = _plan("cpu")
    pts = _points(0, 24)
    prep = plan.prepare_streaming(pts)
    plan.extend(pts[:4], prepared=prep)
    builds_before = plan.stats["prepare_builds"]
    fresh = plan.prepare_data(pts)
    assert fresh is not prep
    assert fresh.streaming is None
    assert plan.stats["prepare_builds"] == builds_before + 1
    again = plan.prepare_data(pts)             # and this one is a hit
    assert again is fresh
    assert plan.stats["prepare_builds"] == builds_before + 1
    plan.forget(prep)
    plan.forget(fresh)


@pytest.mark.parametrize("seeder", SEEDERS)
def test_refit_after_extend_draws_from_grown_stream(seeder):
    """A refit after extend sees the mutation: extras carry the bumped
    generation, the indices stay live, and the new rows can be drawn."""
    plan = _plan("device", seeder=seeder)
    prep = plan.prepare_streaming(_points(0, 24))
    res0 = plan.fit_prepared(prep, seed=3)
    assert res0.extras["generation"] == 0
    assert res0.extras["stream_rebuilds"] == 0
    plan.extend(_points(1, 8), prepared=prep)
    plan.retire([0, 5], prepared=prep)
    res1 = plan.fit_prepared(prep, seed=3)
    assert res1.extras["streaming"] is True
    assert res1.extras["generation"] == 2
    live = prep.streaming.live_ids()
    assert np.isin(res1.indices.numpy(), live).all()
    grown = set()
    for s in range(40):
        grown |= set(plan.fit_prepared(prep, seed=s).indices.tolist())
    assert grown & set(range(24, 32))          # new rows are drawn
    assert not grown & {0, 5}                  # retired rows never are
    plan.forget(prep)


def test_extend_converts_a_static_prep_and_fit_batch_loops():
    """`extend` on a `prepare` handle makes it a stream in place (the
    refits then go through the stream), and `fit_batch(seeds)` over a
    stream is the loop of refits."""
    plan = _plan("device", k=3)
    pts = _points(4, 40)
    plan.prepare(pts)
    prep = plan.extend(_points(5, 10))
    assert prep.streaming is not None and prep.artifacts is None
    assert prep.streaming.n_rows == 50
    batch = plan.fit_batch([1, 2])
    assert batch.extras["vmapped"] is False
    for i, s in enumerate([1, 2]):
        assert torch.equal(batch.indices[i], plan.refit(seed=s).indices)


def test_concurrent_mutations_and_refits_keep_the_stream_whole():
    """Twelve threads extend (across the 1,024-row capacity rung),
    retire and refit one device stream at once, with a short switch
    interval: no update is lost, every refit sees one consistent stream,
    and the patched weights and heap end exact."""
    import sys
    import threading

    plan = _plan("device", k=4)
    pts = _points(9, 1200)
    prep = plan.prepare_streaming(pts[:1000])
    state = prep.streaming
    retired = np.random.default_rng(9).permutation(1000)[:120]
    errors = []

    def work(t):
        try:
            for i in range(10):
                if t < 4:
                    lo = 1000 + 50 * t + 5 * i
                    plan.extend(pts[lo: lo + 5], prepared=prep)
                elif t < 8:
                    plan.retire(retired[30 * (t - 4) + 3 * i:
                                        30 * (t - 4) + 3 * i + 3],
                                prepared=prep)
                else:
                    res = plan.fit_prepared(prep, seed=10 * t + i)
                    idx = res.indices.numpy()
                    assert (idx < state.n_rows).all()
        except Exception as exc:            # reported after the join
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert state.n_rows == 1200 and state.live_count == 1080
    assert state.capacity == 2048
    assert state.generation == 80 == prep.generation
    assert plan.cache_info()["extends"] == plan.cache_info()["retires"] == 40
    want = torch.zeros_like(state.w0)
    want[:state.capacity] = torch.as_tensor(
        state.live, dtype=torch.float32) * state.statics[2]
    assert torch.equal(state.w0, want)
    assert torch.equal(state.base_heap, state.ts.init(state.w0))
    assert [k for k, v in plan._prepared.items() if v is prep] == \
        [prep.fingerprint]
    res = plan.fit_prepared(prep, seed=1)
    assert state.live[res.indices.numpy()].all()


def test_streaming_needs_a_streaming_impl():
    plan = ClusterPlan(ClusterSpec(k=2, seeder="kmeans||"),
                       ExecutionSpec(backend="device", device="cpu"))
    with pytest.raises(ValueError, match="streaming"):
        plan.prepare_streaming(_points(0, 10))
    with pytest.raises(RuntimeError, match="no prepared data"):
        _plan("cpu").extend(_points(0, 3))


# -- the drift layer against the JAX package -------------------------------------

def test_drift_detector_matches_jax_package():
    costs = [100.0, 104.0, 130.0, 180.0, 90.0, 300.0, 301.0]
    for policy in (None, (1.1, 0.3)):
        mine = DriftDetector(policy and DriftPolicy(*policy))
        theirs = jstreaming.DriftDetector(
            policy and jstreaming.DriftPolicy(*policy))
        assert mine.observe(5.0) is theirs.observe(5.0) is False
        mine.observe_fit(100.0)
        theirs.observe_fit(100.0)
        for i, cost in enumerate(costs):
            assert mine.observe(cost) == theirs.observe(cost)
            assert mine.ratio == theirs.ratio
            if i == 4:
                mine.observe_fit(cost)
                theirs.observe_fit(cost)


def test_minibatch_refiner_matches_jax_package():
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(5, 4))
    mine = MiniBatchRefiner(centers)
    theirs = jstreaming.MiniBatchRefiner(centers)
    for _ in range(4):
        batch = rng.normal(size=(30, 4)) + 0.5
        np.testing.assert_array_equal(mine.step(batch), theirs.step(batch))
        np.testing.assert_array_equal(mine.counts, theirs.counts)
    np.testing.assert_array_equal(mine.step(np.empty((0, 4))),
                                  theirs.centers)


@pytest.mark.parametrize("k_min,k_max", [(1, None), (1, 9), (4, 6)])
def test_split_merge_k_matches_jax_package(k_min, k_max):
    rng = np.random.default_rng(21)
    blobs = rng.normal(size=(6, 3)) * 20
    pts = blobs[rng.integers(6, size=400)] + rng.normal(size=(400, 3))
    centers = np.concatenate([blobs[:2], blobs[:2] + 0.01, pts[:2]])
    mine = split_merge_k(pts, centers, np.random.default_rng(3),
                         k_min=k_min, k_max=k_max)
    theirs = jstreaming.split_merge_k(pts, centers,
                                      np.random.default_rng(3),
                                      k_min=k_min, k_max=k_max)
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("seeder", SEEDERS)
def test_streaming_controller_matches_jax_package(seeder):
    """The cpu backend's controller over a stream that drifts away: the
    same reports, reseeds and centers as the JAX package's."""
    rng = np.random.default_rng(31)
    first = rng.normal(size=(200, D))
    batches = [rng.normal(size=(40, D)) + 6.0 * (i // 2) for i in range(6)]
    mine = StreamingController(_plan("cpu", seeder=seeder, k=4), first,
                               seed=2)
    theirs = jstreaming.StreamingController(
        _jax_plan("cpu", seeder=seeder, k=4), first, seed=2)
    reports = []
    for i, batch in enumerate(batches):
        retire = [3 * i, 3 * i + 1] if i % 2 else None
        a = mine.ingest(batch, retire=retire)
        b = theirs.ingest(batch, retire=retire)
        reports.append(a)
        assert (a["drifted"], a["reseeds"], a["live"]) == \
            (b["drifted"], b["reseeds"], b["live"])
        assert a["cost"] == pytest.approx(b["cost"], rel=1e-9)
        assert a["ratio"] == pytest.approx(b["ratio"], rel=1e-5)
        np.testing.assert_array_equal(mine.centers, theirs.centers)
    assert mine.reseeds == theirs.reseeds >= 1
    assert reports[-1]["live"] == 200 + 240 - 6
    np.testing.assert_array_equal(mine.adapt_k(k_max=6),
                                  theirs.adapt_k(k_max=6))


# -- the base weights w0 ---------------------------------------------------------

def _codes(seed, b, n=700):
    """The canonical lanes of B datasets of one shape bucket (1,024 rows,
    d = 4)."""
    return [ClusterPlan(ClusterSpec(k=3, seed=seed + j),
                        ExecutionSpec(device="cpu")).prepare_stacked(
        np.random.default_rng(seed + j).normal(size=(n - 37 * j, 4)))
        .artifacts for j in range(b)]


@pytest.mark.parametrize("b", [1, 3])
def test_lane_start_from_the_n_real_mask_is_unchanged(b):
    """Base weights equal to the `n_real` mask start the lanes from the
    weights and heaps the seeders build without them, bit for bit."""
    lanes = _codes(7, b)
    arrs = ds._stack_lanes(lanes)
    n_real = [lane.n_real for lane in lanes]
    scale, levels, m_init = lanes[0].statics
    kw = dict(scale=scale, num_levels=levels, m_init=m_init, tile=512)
    ts, _, w_plain, heap_plain = ds._lane_start(arrs[0], arrs[1], n_real,
                                                **kw)
    mask = torch.zeros_like(w_plain)
    for j, r in enumerate(n_real):
        mask[j, :r] = m_init
    for base0 in (None, heap_plain.clone()):
        _, _, w, heap = ds._lane_start(arrs[0], arrs[1], n_real, w0=mask,
                                       base0=base0, **kw)
        assert torch.equal(w, w_plain)
        assert torch.equal(heap, heap_plain)


@pytest.mark.parametrize("seeder", SEEDERS)
def test_lanes_over_base_weights_equal_one_lane_solves(seeder):
    """A lane-batched solve over per-lane base weights (retired rows at 0)
    equals each lane's one-lane solve over its own, bit for bit, and
    opens only live rows."""
    lanes = _codes(11, 3)
    arrs = ds._stack_lanes(lanes)
    scale, levels, m_init = lanes[0].statics
    n = arrs[0].shape[-1]
    rng = np.random.default_rng(4)
    w0 = torch.zeros(3, n)
    for j, lane in enumerate(lanes):
        live = rng.random(lane.n_real) < 0.6
        w0[j, :lane.n_real] = torch.as_tensor(live, dtype=torch.float32) \
            * m_init
    kw = dict(scale=scale, num_levels=levels, m_init=m_init, tile=512)

    def gens():
        return [torch.Generator().manual_seed(40 + j) for j in range(3)]

    def solve(j=None):
        sel = slice(None) if j is None else slice(j, j + 1)
        g = gens()[sel]
        if seeder == "rejection":
            return ds.stacked_rejection_sampling(
                *(a[sel] for a in arrs), 8, g, w0=w0[sel], c=1.2, **kw)[0]
        return ds.stacked_fast_kmeanspp(arrs[0][sel], arrs[1][sel], 8, g,
                                        w0=w0[sel], **kw)

    both = solve()
    for j in range(3):
        assert torch.equal(both[j], solve(j)[0])
        assert bool((w0[j, both[j].long()] > 0).all())


def test_zero_weights_draw_live_rows_only():
    """All live rows coincide: after the first center every weight is 0,
    and each later center of Algorithm 4 is a draw over the base weights,
    on live rows only (the retired copies never open), with one trial a
    center."""
    pts = np.tile(np.array([[1.0, 2.0, 3.0]]), (60, 1))
    plan = _plan("device", k=12)
    prep = plan.prepare_streaming(pts)
    plan.retire(np.arange(0, 60, 2), prepared=prep)
    for s in range(5):
        res = plan.fit_prepared(prep, seed=s)
        assert (res.indices.numpy() % 2 == 1).all()
        assert float(res.cost) == 0.0
        assert (res.extras["trials"] == 1).all()
