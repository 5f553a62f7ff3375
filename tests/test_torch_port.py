"""The port's foundations held against the JAX reference on the CPU:
the package imports neither JAX nor the JAX package; its env vars,
fault-injection grammar, autotune overrides and percentile convention
match the reference's; devices and the kernel build fail loudly.

Importing this file also shares the host's cores among pytest-xdist's
workers for torch (:func:`_share_cores_among_workers`): every worker
collects every test file, so the share holds for all the port's tests
in a parallel run."""
import os
import re
import subprocess
import sys

import pytest
import torch


def _share_cores_among_workers():
    """Under pytest-xdist each worker runs torch's ops on all the host's
    cores by default, so N workers run N times as many OpenMP threads as
    there are cores, and the threads spin against each other (the
    port's tests took twice as long with 6 workers on 8 cores).  Give
    each worker its share of the cores, and the processes it starts
    too (``OMP_NUM_THREADS``); a run without workers keeps them all."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        share = -(-(os.cpu_count() or 1) // workers)
        torch.set_num_threads(share)
        os.environ.setdefault("OMP_NUM_THREADS", str(share))


_share_cores_among_workers()

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu import autotune as j_autotune  # noqa: E402
from mxnet_tpu import config as j_config  # noqa: E402
from mxnet_tpu.resilience import faultsim as j_faultsim  # noqa: E402
from mxnet_tpu.telemetry.opstats import percentile as j_percentile  # noqa: E402

import mxnet_tpu.serving  # noqa: E402,F401  (registers serve.* points)
import mxnet_tpu_torch  # noqa: E402
from mxnet_tpu_torch import _kernels  # noqa: E402
from mxnet_tpu_torch import autotune as t_autotune  # noqa: E402
from mxnet_tpu_torch import config as t_config  # noqa: E402
from mxnet_tpu_torch import context as t_context  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as t_faultsim  # noqa: E402
from mxnet_tpu_torch.serving import ServeRejected  # noqa: E402
from mxnet_tpu_torch.telemetry.opstats import percentile as t_percentile  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "mxnet_tpu_torch")
_MODULES = ["mxnet_tpu_torch", "mxnet_tpu_torch.autotune",
            "mxnet_tpu_torch._kernels", "mxnet_tpu_torch.context",
            "mxnet_tpu_torch.ops.flash_attention",
            "mxnet_tpu_torch.quantization",
            "mxnet_tpu_torch.resilience.faultsim",
            "mxnet_tpu_torch.serving",
            "mxnet_tpu_torch.telemetry.opstats",
            "mxnet_tpu_torch.telemetry",
            "mxnet_tpu_torch.telemetry.runlog",
            "mxnet_tpu_torch.telemetry.schema",
            "mxnet_tpu_torch.telemetry.tracing",
            "mxnet_tpu_torch.telemetry.watchdog",
            "mxnet_tpu_torch.telemetry.numerics",
            "mxnet_tpu_torch.telemetry.session",
            "mxnet_tpu_torch.profiler",
            "mxnet_tpu_torch.initializer",
            "mxnet_tpu_torch.gluon",
            "mxnet_tpu_torch.gluon.model_zoo.vision.resnet",
            "mxnet_tpu_torch.ops.conv", "mxnet_tpu_torch.ops.nn",
            "mxnet_tpu_torch.ops.pallas_conv",
            "mxnet_tpu_torch.ops.pallas_opt",
            "mxnet_tpu_torch.optimizer",
            "mxnet_tpu_torch.parallel", "mxnet_tpu_torch.parallel.zero",
            "mxnet_tpu_torch.dtype", "mxnet_tpu_torch.autograd",
            "mxnet_tpu_torch.ops.registry", "mxnet_tpu_torch.ops.elemwise",
            "mxnet_tpu_torch.ops.reduce", "mxnet_tpu_torch.ops.shape_ops",
            "mxnet_tpu_torch.ndarray", "mxnet_tpu_torch.ndarray.ndarray",
            "mxnet_tpu_torch.library",
            "mxnet_tpu_torch.example.plugin.cuda_ops",
            "mxnet_tpu_torch.gluon.trainer", "mxnet_tpu_torch.gluon.data",
            "mxnet_tpu_torch.gluon.parameter",
            "mxnet_tpu_torch.optimizer.optimizer",
            "mxnet_tpu_torch.lr_scheduler", "mxnet_tpu_torch.metric",
            "mxnet_tpu_torch.example.train_mnist",
            "mxnet_tpu_torch.symbol", "mxnet_tpu_torch.symbol.symbol",
            "mxnet_tpu_torch.symbol._op_namespace",
            "mxnet_tpu_torch.symbol._shape_infer",
            "mxnet_tpu_torch.symbol.executor",
            "mxnet_tpu_torch.symbol.contrib",
            "mxnet_tpu_torch.io", "mxnet_tpu_torch.io.io",
            "mxnet_tpu_torch.resilience.checkpoint",
            "mxnet_tpu_torch.model", "mxnet_tpu_torch.callback",
            "mxnet_tpu_torch.monitor", "mxnet_tpu_torch.module",
            "mxnet_tpu_torch.module.base_module",
            "mxnet_tpu_torch.module.module",
            "mxnet_tpu_torch.module.bucketing_module",
            "mxnet_tpu_torch.module.sequential_module",
            "mxnet_tpu_torch.ops.sort_ops",
            "mxnet_tpu_torch.ops.detection_ops",
            "mxnet_tpu_torch.ops.contrib_ops",
            "mxnet_tpu_torch.ndarray.contrib",
            "mxnet_tpu_torch.gluon.model_zoo.vision.ssd",
            "mxnet_tpu_torch.example.train_ssd",
            "mxnet_tpu_torch.recordio", "mxnet_tpu_torch._native",
            "mxnet_tpu_torch.io.device_feed", "mxnet_tpu_torch.io.iterators",
            "mxnet_tpu_torch.io.image_record_iter",
            "mxnet_tpu_torch.io.nvjpeg", "mxnet_tpu_torch.ops.image_augment",
            "mxnet_tpu_torch.image", "mxnet_tpu_torch.kvstore",
            "mxnet_tpu_torch.example.train_imagenet",
            "mxnet_tpu_torch.resilience.elastic",
            "mxnet_tpu_torch.resilience.healing",
            "mxnet_tpu_torch.runtime", "mxnet_tpu_torch.tools.ckpt_fsck"]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|mxnet_tpu)"
                        r"(?:\.|\s|$)", re.M)


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'mxnet_tpu'))\n"
              "print(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_neither_jax_nor_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(_PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_ROOT, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        assert not hits, (path, hits)


_PORT_ENV = ["MXNET_AUTOTUNE", "MXNET_AUTOTUNE_CACHE_DIR",
             "MXNET_FLASH_ATTENTION", "MXNET_FAULT_SPEC",
             "MXNET_KV_PAGE_TOKENS", "MXNET_KV_POOL_BUDGET",
             "MXNET_DECODE_SLOTS", "MXNET_KV_DTYPE",
             "MXNET_PAGED_ATTENTION", "MXNET_BNRELUCONV_VARIANT",
             "MXNET_PALLAS_OPT", "MXNET_KVSTORE_BIGARRAY_BOUND",
             "MXNET_BAD_STEP_LIMIT", "MXNET_CKPT_KEEP",
             "MXNET_OPTIMIZER_SHARDING", "MXNET_SNAPSHOT_EVERY",
             "MXNET_RUNLOG", "MXNET_NUMERICS",
             "MXNET_TELEMETRY_SAMPLE", "MXNET_FLIGHTREC_DEPTH",
             "MXNET_NUMERICS_SAMPLE", "MXNET_METRICS_TEXTFILE",
             "MXNET_TRACE_CONTEXT", "MXNET_PROCESS_ROLE",
             "MXNET_PROCESS_RANK", "MXNET_PROFILER_AUTOSTART",
             "MXNET_PROFILER_MODE", "MXNET_CPU_WORKER_NTHREADS",
             "MXNET_TPU_PREFETCH_BUFFER", "MXNET_IO_WORKERS",
             "MXNET_IO_WORKER_RESPAWN", "MXNET_DEVICE_FEED_DEPTH",
             "MXNET_ZERO_STAGE", "MXNET_ELASTIC", "MXNET_COORDINATOR",
             "MXNET_NUM_PROCESSES", "MXNET_PROCESS_ID",
             "MXNET_DIST_INIT_ATTEMPTS", "MXNET_HEARTBEAT_DIR",
             "MXNET_CKPT_ASYNC", "MXNET_HEAL_MAX_RELAUNCH",
             "MXNET_WATCHDOG_ABORT", "MXNET_CONV_1X1_DOT",
             "MXNET_DTYPE_LADDER", "MXNET_FP8_AMAX_HISTORY"]


@pytest.mark.parametrize("name", _PORT_ENV)
def test_env_vars_match_reference(name, monkeypatch):
    assert name in t_config.list_env()
    want = j_config._ENV[name]
    got = t_config._ENV[name]
    assert (got.default, got.type) == (want.default, want.type)
    assert t_config.get_env(name) == j_config.get_env(name)
    raw = "7" if want.type is int else "int8"
    monkeypatch.setenv(name, raw)
    assert t_config.get_env(name) == j_config.get_env(name)


def test_unregistered_and_malformed_env_raise(monkeypatch):
    with pytest.raises(MXNetError):
        t_config.get_env("MXNET_NOT_A_KNOB")
    monkeypatch.setenv("MXNET_DECODE_SLOTS", "eight")
    with pytest.raises(MXNetError):
        t_config.get_env("MXNET_DECODE_SLOTS")


# ------------------------------------------------------------ faultsim
def _trace(fs, spec, point, n):
    fs.reset(spec)
    out = []
    for _ in range(n):
        try:
            out.append(fs.inject(point))
        except Exception as e:  # FaultInjected of either package
            out.append(type(e).__name__)
    return out, fs.hits(point)


@pytest.mark.parametrize("spec,point", [
    ("serve.decode:raise@2-3", "serve.decode"),
    ("serve.prefill:nan@1;serve.prefill:raise@3+", "serve.prefill"),
    ("serve.admit:delay=0.0@2", "serve.admit"),
    ("", "serve.decode"),
])
def test_faultsim_grammar_matches_reference(spec, point):
    try:
        assert _trace(t_faultsim, spec, point, 5) == \
            _trace(j_faultsim, spec, point, 5)
    finally:
        t_faultsim.reset("")
        j_faultsim.reset("")


@pytest.mark.parametrize("spec", ["nope.point:raise@1",
                                  "serve.decode:explode@1",
                                  "serve.decode:raise",
                                  "serve.decode:raise@x",
                                  "serve.decode:delay=abc@1"])
def test_faultsim_bad_specs_raise(spec):
    with pytest.raises(MXNetError):
        t_faultsim.reset(spec)
    t_faultsim.reset("")


def test_faultsim_points_registered_by_serving():
    assert {"serve.admit", "serve.prefill", "serve.decode"} <= \
        set(t_faultsim.points())


# ------------------------------------------------------------ autotune
@pytest.mark.parametrize("raw", ["0", "1", "naive", "pallas", "PALLAS_PAD",
                                 "pallas_b256", "auto", "on", ""])
def test_flash_override_matches_reference(raw):
    assert t_autotune._parse_flash(raw) == j_autotune._parse_flash(raw)


@pytest.mark.parametrize("raw", ["0", "1", "gather", "paged", "dense",
                                 "auto", "off"])
def test_paged_override_matches_reference(raw, monkeypatch):
    assert t_autotune._parse_paged(raw) == j_autotune._parse_paged(raw)
    monkeypatch.setenv("MXNET_PAGED_ATTENTION", raw)
    assert t_autotune.variant_choice("paged_decode_attention",
                                     default="x") == \
        j_autotune.variant_choice("paged_decode_attention", default="x")


@pytest.mark.parametrize("op,var,raw", [
    ("pallas_bnreluconv", "MXNET_BNRELUCONV_VARIANT", raw)
    for raw in ("stock", "JNP", "pallas", "1", "auto", "")] + [
    ("fused_bucket_opt", "MXNET_PALLAS_OPT", raw)
    for raw in ("1", "on", "0", "off", "pallas", "")])
def test_train_slice_overrides_match_reference(op, var, raw, monkeypatch):
    assert t_autotune.VARIANT_OPS[op] == j_autotune.VARIANT_OPS[op]
    monkeypatch.setenv(var, raw)
    assert t_autotune.variant_choice(op, default="x") == \
        j_autotune.variant_choice(op, default="x")


def test_force_scope_wins_and_unwinds(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "naive")
    assert t_autotune.variant_choice("flash_attention") == "naive"
    with t_autotune.force(flash_attention="pallas_pad"):
        assert t_autotune.variant_choice("flash_attention") == \
            "pallas_pad"
    assert t_autotune.variant_choice("flash_attention") == "naive"


def test_tune_records_and_answers_from_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    t_autotune.cache_clear()
    calls = []

    def measure(value):
        calls.append(value)
        return {"gather": 2.0, "paged": 1.0}[value]

    try:
        variants = t_autotune.VARIANT_OPS["paged_decode_attention"]
        w, info = t_autotune.tune("paged_decode_attention", (2, 3),
                                  "int8", variants, measure, "cuda",
                                  level=1)
        assert (w, info["cached"]) == ("paged", False)
        w2, info2 = t_autotune.tune("paged_decode_attention", (2, 3),
                                    "int8", variants, measure, "cuda",
                                    level=1)
        assert (w2, info2["cached"]) == ("paged", True)
        assert len(calls) == 2
        assert t_autotune.lookup("paged_decode_attention", (2, 3),
                                 "int8", "cpu") is None
        t_autotune.tune("paged_decode_attention", (2, 3), "int8",
                        variants, measure, "cuda", level=2)
        assert len(calls) == 4
        assert t_autotune.tune("x", (1,), "f", {}, measure, "cpu",
                               level=0) == (None, {"enabled": False})
    finally:
        t_autotune.cache_clear()


# ------------------------------------------------------ misc contracts
@pytest.mark.parametrize("vals", [[], [3.0], [1.0, 2.0, 3.0, 4.0],
                                  list(range(101))])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
def test_percentile_matches_reference(vals, q):
    assert t_percentile(vals, q) == j_percentile(vals, q)


def test_serve_rejected_is_structured():
    err = ServeRejected("queue_full", "9 queued")
    assert isinstance(err, MXNetError)
    assert (err.reason, err.detail) == ("queue_full", "9 queued")
    assert "queue_full" in str(err)


def test_devices():
    assert t_context.cpu() == torch.device("cpu")
    assert t_context.gpu(1) == torch.device("cuda", 1)
    assert t_context.default_device() == torch.device("cuda", 0)
    assert mxnet_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(MXNetError):
        t_context.resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            t_context.resolve_device(None)


def test_kv_pool_defaults_to_the_card():
    from mxnet_tpu_torch.serving.kvcache import PagedKVPool

    pool = PagedKVPool(1, 1, 8, page_tokens=4, budget_bytes=1 << 12,
                       device="cpu")
    assert pool.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA card"):
            PagedKVPool(1, 1, 8, page_tokens=4, budget_bytes=1 << 12)


def test_kernel_sources_and_missing_nvcc(monkeypatch, tmp_path):
    """Every CUDA source is listed for the build; without nvcc the
    build raises instead of running anything."""
    assert {"flash_attention", "bnreluconv_bwd", "bucket_sgd"} <= set(
        _kernels.sources())
    assert "sm_90a" in " ".join(_kernels.NVCC_FLAGS)
    key = _kernels._key("flash_attention")
    assert len(key) == 16 and key == _kernels._key("flash_attention")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(MXNetError, match="nvcc"):
        _kernels.build(["flash_attention"])
