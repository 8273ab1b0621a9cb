"""The port's copies of the four examples (`examples_torch/`) against the
JAX package's scripts and functions, on the CPU.

Held here:

  * quickstart: the seeder table's costs are the JAX package's NumPy
    seeders' at the same n, d, k and seed (computed through `repro.core`,
    not by running the JAX script, whose `--smoke` spends most of its time
    in interpret-mode Pallas); the plan, device-backend and engine rows run
    on the CPU (`--device cpu`), and `--backend sharded` over the CPU
    seeding mesh;
  * resilient_serving: on the cpu backend every printed line is the JAX
    script's, times aside (and stage 2's outcomes, which follow the host's
    timing in both), and the `stats()` ledger the same; on
    the device backend (rejection, whose chain has device rungs) the six
    stages hold, the fallback bit for bit;
  * serve_cluster_kv: the cpu backend's cache is the JAX package's build
    bit for bit, and the output error and attention-mass recall are the
    JAX script's within 1e-3 (the same cache, f32 attention in another
    library);
  * train_lm: `make_preset` is the JAX script's (loaded by path), the first
    loss of the tiny preset is the JAX `Trainer`'s within rtol 5e-3 (both
    draw random weights from the same law, from different generators), and
    a rerun in the same workdir resumes with nothing left to do;
  * each copy's default device is the card, which raises without CUDA,
    and quickstart's default backend is the device one.
"""

import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "resilient_serving", "serve_cluster_kv", "train_lm")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(ROOT / "examples_torch" / f"{name}.py", f"port_{name}")


def _jax_script(name):
    return _load(ROOT / "examples" / f"{name}.py", f"jax_{name}")


def _run(main, argv=None, sys_argv=None, monkeypatch=None):
    """(return value, printed lines) of an example's main."""
    buf = io.StringIO()
    if sys_argv is not None:
        monkeypatch.setattr(sys, "argv", sys_argv)
    with contextlib.redirect_stdout(buf):
        out = main() if argv is None else main(argv)
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name, monkeypatch):
    """Without CUDA the default device raises rather than falls back, at a
    small size and with no flags at all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train_lm": ["--steps", "1", "--workdir", "unused"],
            "serve_cluster_kv": ["--seq", "256"]}.get(name, ["--smoke"])
    for args in (argv, []):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port(name).main(args)


def test_quickstart_defaults_to_the_device_backend():
    """Without `--backend` the device-backend plans run (the kernels, on
    the card by default); `--backend cpu` is the JAX script's default run."""
    qs = _port("quickstart")
    args = ["--n", "1500", "--d", "5", "--k", "10", "--device", "cpu"]
    got, lines = _run(qs.main, args)
    assert "device backend plans (1 device(s), schedule=adaptive):" in lines
    assert set(got["device"]) == {"fastkmeans++", "rejection", "kmeans||"}
    for row in got["device"].values():
        assert np.isfinite(row["cost"]) and row["cost"] > 0
    assert "engine" not in got
    got, _ = _run(qs.main, args + ["--backend", "cpu"])
    assert "device" not in got and "engine" not in got


def test_quickstart_rows_match_the_jax_package():
    from repro.core import SEEDERS as JSEEDERS
    from repro.core import clustering_cost as jcost

    qs = _port("quickstart")
    got, lines = _run(qs.main, ["--smoke", "--device", "cpu"])
    pts, _ = qs.make_points(4000, 8, 25, 0)
    assert (got["n"], got["d"], got["k"]) == (4000, 8, 25)
    base = None
    for name in qs.SEEDER_ROWS:
        res = JSEEDERS[name](pts, 25, np.random.default_rng(0))
        want = jcost(pts, res.centers)
        base = want if base is None else base
        assert got["seeders"][name]["cost"] == want, name
        assert got["seeders"][name]["ratio"] == want / base
    assert got["plan"]["lloyd_iterations"] == 5
    assert got["plan"]["cost"] <= got["seeders"]["rejection"]["cost"]
    assert set(got["device"]) == {"fastkmeans++", "rejection", "kmeans||"}
    for row in got["device"].values():
        assert np.isfinite(row["cost"]) and row["cost"] > 0
    rej = got["device"]["rejection"]
    assert rej["vmapped"] and len(rej["batch_costs"]) == 4
    assert got["engine"]["shape_buckets"] >= 1
    assert len(got["engine"]["costs"]) == len(
        got["engine"]["stacked_costs"]) == 3
    assert any(line.startswith("rejection/device") for line in
               (s.strip() for s in lines))
    assert lines[0] == "dataset: n=4000 d=8, seeding k=25"


def test_quickstart_sharded_backend_on_cpu_shards():
    qs = _port("quickstart")
    got, lines = _run(qs.main, ["--n", "1500", "--d", "5", "--k", "10",
                                "--backend", "sharded", "--device", "cpu"])
    assert "sharded backend plans (1 device(s), schedule=adaptive):" in lines
    for row in got["device"].values():
        assert np.isfinite(row["cost"]) and row["cost"] > 0
    assert "engine" not in got


_SECONDS = re.compile(r"\d+\.\d+s")


def test_resilient_serving_prints_the_jax_script_on_the_cpu_backend(
        monkeypatch):
    _, want = _run(_jax_script("resilient_serving").main,
                   sys_argv=["resilient_serving.py", "--smoke"],
                   monkeypatch=monkeypatch)
    got, lines = _run(_port("resilient_serving").main,
                      ["--smoke", "--backend", "cpu", "--device", "cpu"])
    # stage 2's outcomes follow the host's timing (a 0.2 s solve against
    # four quick submits) in either package: held to the ledger instead
    timed = [i for i, s in enumerate(want) if "4 submits ->" in s]
    assert len(timed) == 1

    def steady(out):
        return [_SECONDS.sub("Xs", s) for i, s in enumerate(out)
                if i not in timed]

    assert steady(lines) == steady(want)
    bp = got["backpressure"]
    assert len(bp["outcomes"]) == 4 and bp["outcomes"][-1] == "served"
    assert bp["outcomes"].count("shed") == bp["shed"] >= 1
    assert bp["shed"] + bp["completed"] == 4
    assert got["degradation"]["identical"]
    ledger = got["ledger"]
    assert ledger["completed"] + ledger["failed"] + ledger["cancelled"] == \
        ledger["submitted"] == 6
    line = next(s for s in want if s.strip().startswith("submitted="))
    assert line.strip().startswith(
        f"submitted={ledger['submitted']} completed={ledger['completed']} "
        f"failed={ledger['failed']} cancelled={ledger['cancelled']} "
        f"(injected={ledger['injected']}, retries={ledger['retries']}, "
        f"fallback_served={ledger['fallback_served']})")
    assert f"health={ledger['health']}" in want[-2]


def test_resilient_serving_holds_on_the_device_backend():
    got, lines = _run(_port("resilient_serving").main,
                      ["--smoke", "--device", "cpu"])
    assert got["quarantine"] == {"quarantined": 1, "submitted": 0}
    assert got["backpressure"]["shed"] >= 1
    assert got["deadlines"]["deadline_expired"] == 1
    assert got["retries"]["attempts"] == 2
    assert got["retries"]["served_by"] == "rejection/device"
    assert got["degradation"]["identical"]
    assert got["degradation"]["fallback_path"] == ("rejection/device",)
    # an engine on the CPU keeps the chain's cpu rungs (on the card the
    # fallback is kmeans||/device)
    assert got["degradation"]["served_by"] == "rejection/cpu"
    ledger = got["ledger"]
    assert ledger["completed"] + ledger["failed"] + ledger["cancelled"] == \
        ledger["submitted"] == 6
    assert lines[-1].strip() == \
        "ledger balances: completed + failed + cancelled == submitted"


KV_ARGS = ["--seq", "2048", "--heads", "2", "--clusters", "64", "--topc",
           "8", "--queries", "8"]


def _jax_kv_numbers(lines) -> tuple:
    err = float(re.search(r"max relative output error: ([\d.]+)",
                          "\n".join(lines)).group(1))
    cov = float(re.search(r"covered by gathered clusters: ([\d.]+)",
                          "\n".join(lines)).group(1))
    return err, cov


def test_serve_cluster_kv_cpu_build_is_the_jax_cache(monkeypatch):
    from repro.models import cluster_attn as JCA

    kv = _port("serve_cluster_kv")
    got, lines = _run(kv.main, KV_ARGS + ["--backend", "cpu", "--device",
                                          "cpu"])
    _, _, keys, values = kv.make_kv(2048, 2, 64)
    jcfg = JCA.ClusterKVConfig(num_clusters=64, topc=8, lloyd_iters=2,
                               capacity_slack=3.0)
    want = JCA.build_clustered_cache(keys, values, jcfg)
    for leaf, val in want.items():
        np.testing.assert_array_equal(got["cache"][leaf].numpy(),
                                      np.asarray(val), err_msg=leaf)
    _, jlines = _run(_jax_script("serve_cluster_kv").main,
                     sys_argv=["serve_cluster_kv.py"] + KV_ARGS,
                     monkeypatch=monkeypatch)
    err, cov = _jax_kv_numbers(jlines)
    # the JAX script prints three decimals
    assert abs(got["max_error"] - err) <= 1e-3 + 5e-4
    assert abs(got["coverage"] - cov) <= 1e-3 + 5e-4
    assert lines[-1] == jlines[-1]        # the bytes line


def test_serve_cluster_kv_engine_on_the_device_backend():
    got, lines = _run(_port("serve_cluster_kv").main,
                      KV_ARGS + ["--engine", "--device", "cpu"])
    assert lines[0].startswith("codebook rebuild via ClusterEngine x 2 heads")
    assert got["coverage"] > 0.9 and got["max_error"] < 0.5
    assert got["cache"]["centroids"].shape == (1, 2, 64, 64)


def test_train_lm_matches_the_jax_script(tmp_path):
    from repro.training.trainer import Trainer as JaxTrainer
    from repro.configs.base import TrainConfig as JaxTrainConfig

    port, jax_script = _port("train_lm"), _jax_script("train_lm")
    for preset in ("tiny", "100m"):
        mine, theirs = port.make_preset(preset), jax_script.make_preset(preset)
        assert dataclasses.asdict(mine[0]) == dataclasses.asdict(theirs[0])
        assert mine[1:] == theirs[1:]
    argv = ["--steps", "1", "--workdir", str(tmp_path / "port"),
            "--device", "cpu"]
    got, lines = _run(port.main, argv)
    assert got["ran"] == 1 and got["tokens"] == 8 * 256
    cfg, batch, seq = jax_script.make_preset("tiny")
    tc = JaxTrainConfig(learning_rate=3e-3, warmup_steps=20, total_steps=1,
                        microbatches=1, remat="none", checkpoint_every=50)
    want = JaxTrainer(cfg, tc, workdir=str(tmp_path / "jax"), batch=batch,
                      seq_len=seq).run(1)
    np.testing.assert_allclose(got["losses"][0], want.losses[0], rtol=5e-3)
    again, lines = _run(port.main, argv)
    assert again["ran"] == 0 and again["resumed_from"] == 1
    assert lines[-1] == "nothing to do (already trained to --steps)"
    with pytest.raises(SystemExit, match="sized for the card"):
        port.main(["--preset", "100m", "--device", "cpu"])
