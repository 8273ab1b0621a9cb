"""The port stands alone and never hides the device.

  * No module of `repro_torch`, not `chip_smoke.py` and no script of
    `examples_torch/` imports JAX or the JAX package: a scan of the
    sources and, in a fresh interpreter, the modules loaded after
    importing every `repro_torch` module.
  * Entry points (the plan, the serving engine and its launcher, the
    clustering engine and its RPC launcher) run on CUDA unless the caller
    asks for the CPU, and raise rather than fall back when CUDA is absent.
  * The lock and future rules of `python -m repro.analysis` find nothing
    in the port's threads and futures (and do find a planted breach).
  * The CUDA bindings check their arguments before anything reaches the
    card: a CPU tensor, a wrong dtype, shape or contiguity raises.
  * Training (the `Trainer`, `launch/train.py`) runs on CUDA unless asked
    for the CPU, and the attention's gradient on the card is the backward
    kernel or an error: never the plain version.
"""

import inspect
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import device_seeding as ds
from repro_torch.core.plan import ClusterPlan, ClusterSpec, ExecutionSpec
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import d2_update_cuda as d2u_binding
from repro_torch.kernels import flash_attention_cuda as fa_binding
from repro_torch.kernels import lsh_bucket_accept_cuda as lba_binding
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_argmin_cuda as pam_binding
from repro_torch.kernels import tree_sep_update_cuda as tsu_binding
from repro_torch.launch import cluster_serve, serve
from repro_torch.models import init_params, param_specs
from repro_torch.serving.engine import Engine, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = pathlib.Path(repro_torch.__file__).resolve().parent
FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)\b",
                              re.MULTILINE)


def test_sources_import_no_jax_and_no_reference_package():
    examples = sorted((ROOT / "examples_torch").glob("*.py"))
    assert len(examples) == 4
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        examples
    assert len(sources) > 10
    offenders = [str(p) for p in sources
                 if FORBIDDEN_IMPORT.search(p.read_text())]
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith(('jax.', 'jaxlib')) or n == 'repro'"
        " or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch.')]))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(PACKAGE.parent),
                              "PATH": "/usr/bin:/bin"})
    loaded, bad = out.stdout.strip().splitlines()
    assert int(loaded) >= 15
    assert bad == "[]"


@pytest.mark.parametrize("module", [
    "repro_torch.core.api", "repro_torch.core.multitree",
    "repro_torch.core.tracing", "repro_torch.core.registry",
    "repro_torch.core.seeding", "repro_torch.core.lsh",
    "repro_torch.core.tree_embedding", "repro_torch.kernels._build",
    "repro_torch.core.streaming", "repro_torch.core.resilience",
    "repro_torch.core.engine", "repro_torch.serving.frontend",
    "repro_torch.serving.net.protocol", "repro_torch.serving.net.tenancy",
    "repro_torch.serving.net.server", "repro_torch.serving.net.client",
    "repro_torch.launch.cluster_serve"])
def test_the_cpu_backend_and_legacy_modules_load_no_jax(module):
    """Each module of the CPU backend, the legacy facade, streaming, the
    clustering service and the build accounting, imported alone in a
    fresh interpreter, loads no JAX and no reference package."""
    code = (
        f"import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith(('jax.', 'jaxlib')) or n == 'repro'"
        " or n.startswith('repro.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(PACKAGE.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"
    assert (PACKAGE.parent / (module.replace(".", "/") + ".py")).exists()


def test_legacy_entry_points_do_not_fall_back(monkeypatch):
    """Without CUDA, the legacy `fit` on its default backend and device, a
    cpu-backend plan on its default device and `fit_batch` raise; asked
    for the CPU, they run there."""
    from repro_torch.core import KMeansConfig, fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(60, 3))
    with pytest.warns(DeprecationWarning):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fit(pts, KMeansConfig(k=3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterPlan(ClusterSpec(k=3, seeder="kmeans++"),
                    ExecutionSpec(backend="cpu"))
    with pytest.warns(DeprecationWarning):
        assert fit(pts, KMeansConfig(k=3, device="cpu")).centers.shape == (3, 3)
        assert fit(pts, KMeansConfig(k=3, backend="cpu")).cost > 0
    plan = ClusterPlan(ClusterSpec(k=3, seeder="kmeans++"),
                       ExecutionSpec(backend="cpu", device="cpu"))
    assert plan.fit_batch([0, 1], pts).indices.device.type == "cpu"


def test_entry_points_default_to_cuda():
    spec = ExecutionSpec()
    assert spec.device == "cuda" and spec.backend == "device"
    engine_device = inspect.signature(Engine).parameters["device"]
    assert engine_device.default == "cuda"
    assert serve.build_parser().parse_args([]).device == "cuda"
    args = cluster_serve.build_parser().parse_args([])
    assert (args.backend, args.device) == ("device", "cuda")


def test_no_silent_cpu_fallback(monkeypatch):
    """Without CUDA, an entry point that was not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterPlan(ClusterSpec(k=3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterPlan(ClusterSpec(k=3, seeder="fastkmeans++"),
                    ExecutionSpec(backend="device", device="cuda:0"))
    ClusterPlan(ClusterSpec(k=3), ExecutionSpec(device="cpu"))   # asked for


def test_serving_entry_points_do_not_fall_back(monkeypatch):
    """Without CUDA, the engine and the launcher on their default device
    raise; asked for the CPU, they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("yi-9b"))
    params = init_params(param_specs(cfg), torch.Generator(), torch.float32,
                         "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--tokens", "1"])
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=1, max_seq=8),
                 device="cpu")
    assert eng.generate(np.ones((1, 4), np.int32)).shape == (1, 1)


@pytest.mark.timeout(120)
def test_cluster_service_does_not_fall_back(monkeypatch, capsys):
    """Without CUDA, the engine on its default placement refuses a request
    and the RPC launcher's smoke fails it; asked for the CPU, both run."""
    from repro_torch.core import ClusterEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(64, 3))
    with ClusterEngine(ClusterSpec(k=3)) as engine:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.submit(pts)
    argv = ["--smoke", "--smoke-requests", "2", "--smoke-n", "64"]
    assert cluster_serve.main(argv) == 1
    assert "CUDA is not available" in capsys.readouterr().out
    assert cluster_serve.main(argv + ["--device", "cpu"]) == 0
    assert "smoke: PASS" in capsys.readouterr().out


@pytest.mark.timeout(600)
def test_lock_and_future_lint_finds_nothing_in_the_port(tmp_path):
    """`python -m repro.analysis`'s framework-neutral thread rules over
    `src/repro_torch` find nothing (the baseline has no entry for the
    port), and they are live: a planted breach of each is found."""
    rules = ["--rule", "lock-discipline", "--rule", "future-discipline"]

    def lint(*paths):
        return subprocess.run(
            [sys.executable, "-m", "repro.analysis", "--strict", *rules,
             *map(str, paths)], capture_output=True, text=True, cwd=ROOT,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "JAX_PLATFORMS": "cpu"}, timeout=300)

    clean = lint(PACKAGE)
    assert clean.returncode == 0 and "no findings" in clean.stdout, \
        clean.stdout + clean.stderr
    planted = tmp_path / "planted.py"
    planted.write_text(
        "import threading\n\n\n"
        "class Racy:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0\n\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n\n"
        "    def peek(self):\n"
        "        return self.n\n\n\n"
        "def settle(fut, fn):\n"
        "    fut.set_result(fn())\n")
    found = lint(planted)
    assert found.returncode == 1
    assert "lock-discipline" in found.stdout
    assert "future-discipline" in found.stdout


def test_wrappers_refuse_other_devices():
    w = torch.zeros(8, device="meta")
    codes = torch.zeros((3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.tree_sep_update(codes, codes, codes[:, 0], codes[:, 0], w,
                            scale=1.0, num_levels=4)


def _sweep_args(h=4, n=64):
    lo = torch.zeros((h, n), dtype=torch.int32)
    return [lo, lo.clone(), lo[:, 0], lo[:, 0], torch.zeros(n)]


def _accept_args(b=8, k=32, l=15, d=6):
    keys_q = torch.zeros((l, b), dtype=torch.int32)
    keys_c = torch.zeros((l, k), dtype=torch.int32)
    return [keys_q, keys_q.clone(), torch.zeros((b, d)), keys_c,
            keys_c.clone(), torch.zeros((k, d)), torch.zeros(b)]


def _bad_variants(args, sizes):
    """(argument index, bad tensor) pairs: wrong dtype, wrong shape and
    non-contiguous versions of the argument at each index in `sizes`."""
    for i in sizes:
        t = args[i]
        wrong_dtype = (t.to(torch.float64) if t.is_floating_point()
                       else t.to(torch.int64))
        yield i, wrong_dtype
        yield i, torch.cat([t, t[..., :1]], dim=-1)
        if t.dim() == 2 and t.shape[1] > 1:
            yield i, torch.cat([t, t], dim=1)[:, ::2]


def _binding_call(which):
    """(arguments, indices to corrupt, call) of one binding's launch."""
    if which in ("sweep", "tiles"):
        kw = dict(scale=1.0, num_levels=5)
        if which == "sweep":
            return _sweep_args(), [0, 1, 4], \
                lambda a: tsu_binding.launch(*a, **kw)
        return _sweep_args(), [0, 1, 4], \
            lambda a: tsu_binding.launch_tiles(*a, tile=32, **kw)
    if which == "accept":
        return _accept_args(), range(7), \
            lambda a: lba_binding.launch(*a, count=5, c2=4.0)
    if which == "lsh_min":
        return _accept_args()[:6], range(6), \
            lambda a: lba_binding.launch_min(*a, count=5)
    if which == "flash":
        q, kv = torch.zeros((1, 64, 4, 8)), torch.zeros((1, 64, 2, 8))
        return [q, kv, kv.clone()], [0, 1, 2], \
            lambda a: fa_binding.launch(*a, scale=1.0, causal=True)
    if which == "pairwise":
        return [torch.zeros((128, 5)), torch.zeros((128, 5))], [0, 1], \
            lambda a: pam_binding.launch(*a)
    args = [torch.zeros((64, 5)), torch.zeros(5), torch.zeros(64)]
    if which == "d2":
        return args, [0, 1, 2], lambda a: d2u_binding.launch(*a)
    return args, [0, 1, 2], lambda a: d2u_binding.launch_tiles(*a, tile=32)


@pytest.mark.parametrize("which", ["sweep", "tiles", "accept", "lsh_min",
                                   "pairwise", "d2", "d2_tiles", "flash"])
def test_bindings_check_arguments_before_launching(which):
    """The bindings refuse a CPU tensor passed as if it were on the card and
    every wrong dtype, shape or contiguity, before loading any library."""
    args, sizes, call = _binding_call(which)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        call(args)
    bad = 0
    for i, t in _bad_variants(args, sizes):
        a = list(args)
        a[i] = t
        with pytest.raises((TypeError, ValueError)) as err:
            call(a)
        assert "CUDA kernel got a tensor" not in str(err.value)
        bad += 1
    # every argument gets a wrong dtype and shape, every matrix a stride
    assert bad == sum(3 if args[i].dim() == 2 and args[i].shape[1] > 1
                      else 2 for i in sizes) >= 6
    assert ops.launch_counts() == {name: 0 for name in ops.LAUNCHES}


def test_bindings_check_kernel_block_shapes():
    # The LSH kernel guards both edges (any B, any K) but reads only the
    # first `count` slots, so a count outside 0..K is what it refuses.
    a = _accept_args(b=12)
    for count in (-1, 33):
        with pytest.raises(ValueError, match="count must be in 0..32"):
            lba_binding.launch(*a, count=count, c2=1.0)
    with pytest.raises(ValueError, match="tile must be"):
        tsu_binding.launch_tiles(*_sweep_args(n=48), scale=1.0, num_levels=5,
                                 tile=32)
    with pytest.raises(ValueError, match="at most 64 code rows"):
        tsu_binding.launch(*_sweep_args(h=65), scale=1.0, num_levels=66)
    with pytest.raises(ValueError, match="count must be in 0..32"):
        lba_binding.launch_min(*a[:6], count=40)
    # `pairwise_argmin` guards its ragged point edge (any n) but sweeps
    # whole tiles of 128 center slots.
    for n, k in ((128, 100), (128, 0)):
        with pytest.raises(ValueError, match="multiple of 128"):
            pam_binding.launch(torch.zeros((n, 3)), torch.zeros((k, 3)))
    with pytest.raises(TypeError, match="must be one of"):
        pam_binding.launch(torch.zeros((128, 3), dtype=torch.float16),
                           torch.zeros((128, 3), dtype=torch.float16))
    # `d2_update_tiles` guards its ragged edge (any n) but sums whole
    # 32-row units, so a tile that is not a multiple of 32 in [32, 1024] is
    # what it refuses; n = 48 at tile 32 passes the shape checks.
    for tile in (48, 2048):
        with pytest.raises(ValueError, match="tile must be"):
            d2u_binding.launch_tiles(torch.zeros((48, 3)), torch.zeros(3),
                                     torch.zeros(48), tile=tile)
    with pytest.raises(ValueError, match="CPU tensors take the plain"):
        d2u_binding.launch_tiles(torch.zeros((48, 3)), torch.zeros(3),
                                 torch.zeros(48), tile=32)


def test_flash_binding_checks_heads_before_launching():
    """A head dimension over 256, KV heads that do not divide the query
    heads, mixed dtypes and a strided head dimension raise before any
    library loads."""
    def call(q, k, v=None):
        return fa_binding.launch(q, k, k if v is None else v, scale=1.0,
                                 causal=True)

    with pytest.raises(ValueError, match="outside 1..256"):
        call(torch.zeros((1, 8, 4, 264)), torch.zeros((1, 8, 2, 264)))
    with pytest.raises(ValueError, match="do not divide"):
        call(torch.zeros((1, 8, 6, 8)), torch.zeros((1, 8, 4, 8)))
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        call(torch.zeros((1, 8, 4, 8), dtype=torch.bfloat16),
             torch.zeros((1, 8, 2, 8)))
    with pytest.raises(TypeError, match="must be a tensor of one of"):
        call(torch.zeros((1, 8, 4, 8), dtype=torch.float16),
             torch.zeros((1, 8, 2, 8), dtype=torch.float16))
    with pytest.raises(ValueError, match="head dimension must be contiguous"):
        call(torch.zeros((1, 8, 4, 16))[..., ::2], torch.zeros((1, 8, 2, 8)))
    with pytest.raises(ValueError, match="must have shape"):
        call(torch.zeros((1, 8, 4, 8)), torch.zeros((1, 9, 2, 8)))
    assert ops.launch_counts() == {name: 0 for name in ops.LAUNCHES}


def test_prepare_uploads_only_where_asked():
    pts = np.random.default_rng(0).normal(size=(50, 3))
    data = ds.prepare_rejection(pts, seed=1, device="cpu")
    assert data.codes_lo.device.type == data.points.device.type == "cpu"


@pytest.mark.parametrize("module", [
    "repro_torch.optim.adamw", "repro_torch.data.tokens",
    "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpointer",
    "repro_torch.training.train_step", "repro_torch.training.trainer",
    "repro_torch.launch.train"])
def test_training_modules_load_no_jax(module):
    """Each module of the training slice, imported alone in a fresh
    interpreter, loads no JAX and no reference package."""
    code = (
        f"import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith(('jax.', 'jaxlib')) or n == 'repro'"
        " or n.startswith('repro.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(PACKAGE.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The Trainer and the launcher default to the card; without CUDA they
    raise; asked for the CPU, they run there."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import train
    from repro_torch.training.trainer import Trainer

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert train.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainConfig(), workdir=tmp_path, batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--workdir", str(tmp_path)])
    assert Trainer(cfg, TrainConfig(), workdir=tmp_path, batch=2, seq_len=8,
                   device="cpu").device.type == "cpu"


def test_flash_backward_failure_raises_without_fallback(monkeypatch):
    """On the card, `attention_bshd` under autograd runs the forward kernel
    and, for the gradient, the backward kernel: if that launch fails the
    error reaches the caller, and the plain version is never called.  The
    card is stood in for by CPU tensors the wrappers take for CUDA ones."""
    from repro_torch.kernels._check import CudaLaunchError

    calls = []

    def forward(q, k, v, *, scale, causal, prefix_len=0, with_lse=False):
        b, s, h, _ = q.shape
        out = torch.zeros((b, s, h, v.shape[3]))
        return (out, torch.zeros((b, h, s))) if with_lse else out

    def backward(*args, **kw):
        calls.append("bwd")
        raise CudaLaunchError("flash_attention_bwd", 98)

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on the card's path")

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(fa_binding, "launch", forward)
    monkeypatch.setattr(fa_binding, "launch_backward", backward)
    monkeypatch.setattr(ops.ref, "attention_bshd_ref", plain)
    ops.reset_launch_counts()
    q = torch.zeros((1, 8, 2, 4), requires_grad=True)
    out = ops.attention_bshd(q, q.detach(), q.detach(), scale=0.5,
                             causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    with pytest.raises(CudaLaunchError, match="cudaError_t 98"):
        out.sum().backward()
    assert calls == ["bwd"]
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    assert q.grad is None
    ops.reset_launch_counts()


def test_flash_backward_binding_checks_before_launching():
    """The backward binding refuses CPU tensors, a wrong `out`, `lse` or
    `dout` before any library loads."""
    ops.reset_launch_counts()
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    out, lse, dout = (torch.zeros((1, 8, 4, 16)), torch.zeros((1, 4, 8)),
                      torch.zeros((1, 8, 4, 16)))
    kw = dict(scale=0.25, causal=True)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        fa_binding.launch_backward(q, k, k, out, dout, lse, **kw)
    with pytest.raises(ValueError, match="must have shape"):
        fa_binding.launch_backward(q, k, k, out, dout, lse[:, :, :4], **kw)
    with pytest.raises(TypeError, match="must be torch.float32"):
        fa_binding.launch_backward(q, k, k, out.double(), dout, lse, **kw)
    with pytest.raises(ValueError, match="dout must have shape"):
        fa_binding.launch_backward(q, k, k, out, dout[:, :4], lse, **kw)
    assert ops.launch_counts() == {name: 0 for name in ops.LAUNCHES}
