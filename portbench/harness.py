"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to a configuration, a traffic mix, a metric or a
compared number is a file found by its name in `BENCHMARK.json`:

* ``configs/<name>.json`` (the configuration's ``file``): the points' law
  (``"data"``), the plan (``"cluster"``, ``"execution"``), the prepare the
  reference works out again (``"prepare"``), and the numbers compared with
  their limits (``"checks"``);
* ``traffic/<name>.json``: a closed loop of one client; each request is
  ``ClusterPlan.fit_batch(seeds)`` with ``"lanes"`` fresh seeds, after
  ``"warmup_requests"`` requests in set-up; a traced run profiles the
  window's first ``"traced_requests"``.  A mix with any other key is
  refused (`MIX_KEYS`): this loop would not honour it;
* ``metrics/<name>.py``: ``read(run) -> float | None`` for each metric;
* ``checks/<name>.py``: ``compute(ctx) -> float | None`` for each number
  compared; the run is correct when every one is at or under its limit.

The harness imports the port (`repro_torch`) and nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

from portbench import counts, faults
from portbench import trace as tracing
from portbench.datasets import make_points
from portbench.reference import Reference

__all__ = ["MIX_KEYS", "Request", "Run", "CheckContext", "load_manifest", "find_cell",
           "metric_entries", "load_reader", "derive_seeds", "request_seeds",
           "run_cell"]

_CHECK_SEED, _DATA_SEED, _SPEC_SEED, _REQUEST_SEED = 4, 1, 2, 3
MIX_KEYS = {"name", "lanes", "warmup_requests", "traced_requests"}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(manifest: dict, name: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration entry)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def metric_entries(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those with no ``workloads`` key and those that list it."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(root: Path, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream(seed: int, *words: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % 2 ** 64, *words])


def derive_seeds(seed: int) -> dict:
    """The run's seeds from `--seed`: the points', the plan's (its prepare
    draws) and the check's row sample."""
    data = _stream(seed, _DATA_SEED).generate_state(2, dtype=np.uint32)
    return {
        "data": int(data[0]) << 31 | int(data[1]) >> 1,
        "spec": int(_stream(seed, _SPEC_SEED).generate_state(1)[0] >> 1),
        "check": _stream(seed, _CHECK_SEED),
    }


def request_seeds(seed: int, request: int, lanes: int) -> list[int]:
    """Request `request`'s lane seeds (request 0 is the first warm-up):
    fresh in every request, distinct within it."""
    rng = np.random.default_rng(_stream(seed, _REQUEST_SEED, request))
    return [int(s) for s in rng.choice(2 ** 31 - 1, size=lanes,
                                       replace=False) + 1]


@dataclasses.dataclass
class Request:
    """One answered request of the window (its tensors moved to the host
    once the window closed)."""

    t0: float
    t1: float
    seeds: list
    result: Any = None            # the FitResult, until the window closed
    indices: Any = None           # (lanes, k) int64
    centers: Any = None           # (lanes, k, d) float64
    cost: Any = None              # (lanes,) float64
    trials: Any = None            # (lanes, k) int64, or None
    error: Optional[str] = None


@dataclasses.dataclass
class Run:
    """What the metrics read: the spans the harness took around the
    program's layers, the program's counters and the trace."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    prepare_s: float
    requests: list
    peak_bytes: int               # device peak over the window
    shapes: dict                  # n, n_pad, levels, trees, lanes, tile, k
    trace: Optional[tracing.Trace] = None
    traced: list = dataclasses.field(default_factory=list)

    @property
    def answered(self) -> list:
        return [r for r in self.requests if r.error is None]

    @property
    def traced_s(self) -> float:
        """The traced window: its first request's start to its last one's
        end (the profile opens and closes around them)."""
        return self.traced[-1].t1 - self.traced[0].t0 if self.traced else 0.0


@dataclasses.dataclass
class CheckContext:
    """What the compared numbers read: the benchmark's own points and
    seeds, the reference, the port's answers and a sample of what its
    prepare made."""

    config: dict
    points: np.ndarray
    reference: Reference
    requests: list
    prepared: Optional[dict]      # the port's prepare at `rows`, or None
    rows: np.ndarray
    device: Any
    rng: np.random.Generator      # the check's own draws, from the seed


def _sample_prepared(prep, rows, torch) -> Optional[dict]:
    """The port's prepared artifacts at `rows`, on the host: quantised
    points, codes (trees, levels, rows) as two int32 planes, and for the
    rejection seeder its f32 points and LSH keys (tables, rows); None when
    the artifacts have a form this does not know."""
    art = prep.artifacts
    if hasattr(art, "codes_lo"):
        lo, hi = art.codes_lo, art.codes_hi
        statics = (art.scale, art.num_levels, art.m_init)
        extra = (art.points, art.keys_lo, art.keys_hi)
    elif isinstance(art, tuple) and len(art) == 3 and isinstance(art[2],
                                                                  dict):
        lo, hi, meta = art
        statics = (meta["scale"], meta["num_levels"], meta["m_init"])
        extra = None
    else:
        return None
    idx = torch.as_tensor(rows, device=lo.device)
    out = {"seed_pts": np.asarray(prep.seed_pts)[rows],
           "codes_lo": lo[..., idx].cpu().numpy(),
           "codes_hi": hi[..., idx].cpu().numpy(),
           "statics": tuple(float(s) for s in statics)}
    if extra is not None:
        pts, klo, khi = extra
        out.update(points=pts[idx].cpu().numpy(),
                   keys_lo=klo[:, idx].cpu().numpy(),
                   keys_hi=khi[:, idx].cpu().numpy())
    return out


def _answers_to_host(requests: list) -> None:
    for r in requests:
        res, r.result = r.result, None
        if res is None:
            continue
        r.indices = res.indices.cpu().numpy().astype(np.int64)
        r.centers = res.centers.cpu().double().numpy()
        r.cost = res.cost.cpu().double().numpy()
        t = res.extras.get("trials")
        r.trials = None if t is None else t.cpu().numpy().astype(np.int64)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", control: bool = False,
             fault: Optional[str] = None,
             t_start: Optional[float] = None) -> dict:
    """Run cell `cell_name` once and return its result (the JSON object the
    benchmark prints).  `control` computes the program's gathers and costs
    in bfloat16, the precision below the configuration's float32, and
    `fault` plants one of `portbench.faults` under the window's requests:
    the check must call either run not correct."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core import tracing as program_tracing
    from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
    from repro_torch.kernels import ops

    root = Path(root)
    manifest = load_manifest(root)
    cell, config_entry = find_cell(manifest, cell_name)
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    unknown = set(traffic) - MIX_KEYS
    if unknown:
        raise ValueError(f"mix {cell['traffic']!r} has keys this closed loop "
                         f"of one client does not read: {sorted(unknown)}")
    lanes = int(traffic["lanes"])
    seeds = derive_seeds(seed)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- set-up: the points, the plan, its prepare, the warm-up ----------
    points = make_points(config["data"], seeds["data"], device)
    execution = dict(config["execution"], device=device)
    if control:
        execution["dtype"] = "bfloat16"
    plan = ClusterPlan(ClusterSpec(seed=seeds["spec"], **config["cluster"]),
                       ExecutionSpec(**execution))
    plan.prepare(points)
    prep = plan.prepare_data(points)          # the same handle: a cache hit
    for w in range(int(traffic["warmup_requests"])):
        plan.fit_batch(request_seeds(seed, w, lanes))
    sync()
    setup_s = time.perf_counter() - t_start

    # -- the measured window ---------------------------------------------
    builds0 = dict(program_tracing.TRACE_COUNTS)
    launches0 = dict(ops.LAUNCHES)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prof = tr = None
    traced = int(traffic["traced_requests"]) if trace else 0
    if trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    undo = faults.plant(fault) if fault else None
    requests = []
    first = int(traffic["warmup_requests"])
    t_open = time.perf_counter()
    while True:
        req = Request(t0=0.0, t1=0.0,
                      seeds=request_seeds(seed, first + len(requests), lanes))
        req.t0 = time.perf_counter()
        try:
            req.result = plan.fit_batch(req.seeds)    # ends in a sync
        except Exception as exc:                       # noqa: BLE001
            req.error = f"{type(exc).__name__}: {exc}"
            _log(f"request {len(requests)} failed: {req.error}")
        req.t1 = time.perf_counter()
        requests.append(req)
        if len(requests) == traced:
            sync()
            prof.__exit__(None, None, None)
        if req.t1 - t_open >= seconds:
            break
    sync()
    if undo is not None:
        undo()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = {k: v - launches0.get(k, 0) for k, v in ops.LAUNCHES.items()}
    builds = {k: v - builds0.get(k, 0)
              for k, v in program_tracing.TRACE_COUNTS.items()
              if v != builds0.get(k, 0)}
    if builds:
        raise RuntimeError(f"kernels built inside the window: {builds}")
    steps = int(config["cluster"]["k"]) * len(requests)
    _log(f"window: {len(requests)} requests in "
         f"{requests[-1].t1 - requests[0].t0!r} s ("
         + ", ".join(f"{r.t1 - r.t0:.3f}" for r in requests)
         + " s each), kernel launches a center step "
         + ", ".join(f"{k} {v / steps:g}" for k, v in launches.items() if v))

    # -- the port's answers, then its state freed ------------------------
    _answers_to_host(requests)
    trials = [r.trials for r in requests if r.trials is not None]
    if trials:
        _log(f"trials a center: {np.mean(np.concatenate(trials))!r}")
    n = points.shape[0]
    rng = np.random.default_rng(seeds["check"])
    rows = np.sort(rng.choice(n, size=min(int(config["check_rows"]), n),
                              replace=False))
    prepared = _sample_prepared(prep, rows, torch)
    prepare_s = float(prep.prepare_seconds)
    if prof is not None:
        tr = tracing.read(prof, torch)
    del plan, prep, prof
    if on_card:
        torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    reference = Reference(points, config["cluster"], config["prepare"],
                          seeds["spec"])
    _log(f"reference: {reference.trees.num_levels} tree levels, max_dist "
         f"{reference.trees.max_dist!r}")
    ctx = CheckContext(config=config, points=points, reference=reference,
                       requests=requests, prepared=prepared, rows=rows,
                       device=device, rng=rng)
    checks = {}
    for name, limit in config["checks"].items():
        try:
            value = load_reader(root, "checks", name).compute(ctx)
        except Exception as exc:                       # noqa: BLE001
            _log(f"check {name} raised {type(exc).__name__}: {exc}")
            value = None
        checks[name] = {"value": value, "limit": limit}
    failed = sum(len(r.seeds) for r in requests if r.error is not None)
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    # -- the metrics ------------------------------------------------------
    tile = int(config["execution"]["tile"])
    shapes = {"n": n, "n_pad": counts.padded_rows(n, tile),
              "levels": reference.trees.num_levels - 1,
              "trees": int(config["prepare"]["trees"]), "lanes": lanes,
              "tile": tile, "k": int(config["cluster"]["k"])}
    run = Run(cell=cell, config=config, traffic=traffic, setup_s=setup_s,
              prepare_s=prepare_s, requests=requests, peak_bytes=window_peak,
              shapes=shapes, trace=tr,
              traced=requests[:traced])
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]
             + manifest["per_layer"]}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in metric_entries(manifest, cell_name, kind):
        value = load_reader(root, "metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit":
                                      units[entry["name"]]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct),
              "attempted": sum(len(r.seeds) for r in requests),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=run.traced_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.gaps}
    result["checks"] = checks
    return result
