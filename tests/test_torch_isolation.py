"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, no source of it imports either (the request context, the fault
and failover layers and the kill/restart harness's trainer process
included), and with no device given and no CUDA present its entry points
raise instead of running on the CPU."""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import strom_torch
from strom_torch.delivery.core import StromContext, resolve_device
from strom_torch.formats.parquet import write_parquet
from strom_torch.formats.rawbin import write_token_shard
from strom_torch.models.llama import Llama, LlamaConfig
from strom_torch.parallel.train import init_train_state, make_train_step
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.parquet_scan import (parquet_count_where,
                                                parquet_scan_aggregate)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "strom_torch"


def test_import_loads_no_jax_and_no_strom():
    code = (
        "import pkgutil, importlib, sys, strom_torch\n"
        "for m in pkgutil.walk_packages(strom_torch.__path__, 'strom_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "print(len([n for n in sys.modules if n.startswith('strom_torch')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20   # every module was imported


@pytest.mark.parametrize("module", ["strom_torch.ckpt",
                                    "strom_torch.pipelines.checkpoint"])
def test_checkpoint_modules_load_no_jax_strom_or_ml_dtypes(module):
    """The checkpoint layer carries bf16 as an integer view: importing it
    (and a save and restore of a bf16 leaf) loads no jax*, strom.* or
    ml_dtypes module."""
    code = (
        f"import sys, tempfile, torch, {module}\n"
        "from strom_torch.ckpt import restore_checkpoint, save_checkpoint\n"
        "from strom_torch.delivery.core import StromContext\n"
        "from strom_torch.config import StromConfig\n"
        "d = tempfile.mkdtemp()\n"
        "t = {'w': torch.ones(3, dtype=torch.bfloat16)}\n"
        "with StromContext(StromConfig(engine='python')) as ctx:\n"
        "    save_checkpoint(ctx, d + '/c', t)\n"
        "    assert torch.equal(restore_checkpoint(ctx, d + '/c', t)['w'], "
        "t['w'])\n"
        "bad = sorted(n for n in sys.modules if n.startswith(('jax', "
        "'ml_dtypes')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|strom)\b(?!_torch)|"
                        r"from\s+(jax|strom)\b(?!_torch))", re.MULTILINE)


def test_sources_import_neither_jax_nor_strom():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    offenders = {str(f.relative_to(ROOT)): m.group(0).strip()
                 for f in files for m in [_FORBIDDEN.search(f.read_text())] if m}
    assert not offenders, offenders
    chip_smoke = (ROOT / "chip_smoke.py").read_text()
    assert not _FORBIDDEN.search(chip_smoke)
    # the write path and the checkpoint layer are scanned, and import no
    # ml_dtypes (a dependency of JAX)
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"ckpt/checkpoint.py", "ckpt/async_save.py", "ckpt/jobstate.py",
            "pipelines/checkpoint.py"} <= names
    uses = [str(f.relative_to(ROOT)) for f in files + [ROOT / "chip_smoke.py"]
            if re.search(r"^\s*(import|from)\s+ml_dtypes\b",
                         f.read_text(), re.MULTILINE)]
    assert not uses, uses


def test_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "import strom", "from strom.config import X",
                 "    from strom.delivery import core"):
        assert _FORBIDDEN.search(line), line
    for line in ("import strom_torch", "from strom_torch.ops import build",
                 "import jaxtyping", "# from jax import lax"):
        assert not _FORBIDDEN.search(line), line


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    path = str(tmp_path / "t.bin")
    pq_path = str(tmp_path / "t.parquet")
    values = np.arange(-50, 50, dtype=np.float32)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    ctx = StromContext()
    try:
        write_token_shard(ctx, path, np.arange(4 * 17, dtype=np.int32),
                          fsync=False)
        write_parquet(ctx, pq_path, {"value": values}, row_group_rows=40,
                      fsync=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctx.memcpy_ssd2gpu(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_llama_pipeline(ctx, [path], batch=2, seq_len=16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parquet_count_where(ctx, [pq_path], "value", lambda v: v > 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parquet_scan_aggregate(ctx, [pq_path], ["value"],
                                   lambda c: c["value"].sum())
        # asked for, the CPU runs the scan
        assert parquet_count_where(ctx, [pq_path], "value", lambda v: v > 0,
                                   devices=["cpu"]) == 49
        assert parquet_scan_aggregate(ctx, [pq_path], ["value"],
                                      lambda c: c["value"].sum(),
                                      devices=["cpu"]) == values.sum()
    finally:
        ctx.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strom_torch.memcpy_ssd2gpu(path)
    strom_torch.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)
    # asked for, the CPU works
    assert resolve_device("cpu") == torch.device("cpu")


_TOP_LEVEL_PYARROW = re.compile(r"^(import\s+pyarrow\b|from\s+pyarrow\b)",
                                re.MULTILINE)


def test_pyarrow_is_imported_only_inside_functions():
    """pyarrow is optional: no source of the port, nor chip_smoke.py,
    imports it at module level (an indented import sits inside a function,
    where only the route that needs it runs it)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _TOP_LEVEL_PYARROW.search(f.read_text())]
    assert not offenders, offenders
    assert _TOP_LEVEL_PYARROW.search("import pyarrow.parquet as pq")
    assert not _TOP_LEVEL_PYARROW.search("    import pyarrow.parquet as pq")
    # and the modules that use it do import it somewhere
    assert re.search(r"^\s+import pyarrow", (
        PKG / "formats" / "parquet.py").read_text(), re.MULTILINE)


def test_scan_covers_the_scheduler_and_utils():
    """The source scan reaches the scheduler, the stats registry, the
    codec and the spill tier, and none of them imports jax or strom."""
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    assert {"sched/__init__.py", "sched/scheduler.py", "sched/budget.py",
            "sched/tenant.py", "utils/__init__.py", "utils/stats.py",
            "utils/codec.py", "delivery/spill.py"} <= names
    for sub in ("sched", "utils"):
        for f in (PKG / sub).rglob("*.py"):
            assert not _FORBIDDEN.search(f.read_text()), f


@pytest.mark.parametrize("module", ["strom_torch.obs",
                                    "strom_torch.obs.request",
                                    "strom_torch.faults",
                                    "strom_torch.faults.resume_harness",
                                    "strom_torch.delivery.resilient",
                                    "strom_torch.engine.resilience"])
def test_resilience_modules_load_no_jax_or_strom(module, tmp_path):
    """The request context, the fault layer and the failover layer load
    neither jax* nor strom.*, also with a fault plan driving a read."""
    shard = tmp_path / "d.bin"
    shard.write_bytes(bytes(range(256)) * 1024)
    code = (
        f"import sys, {module}\n"
        "from strom_torch.config import StromConfig\n"
        "from strom_torch.delivery.core import StromContext\n"
        "cfg = StromConfig(engine='python', fault_plan='chaos:1',"
        " io_retries=3)\n"
        "with StromContext(cfg) as ctx:\n"
        "    assert bytes(ctx.pread(sys.argv[1], 0, 4096, deadline_s=30)) =="
        " bytes(range(256)) * 16\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(shard)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_scan_covers_obs_and_faults():
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    assert {"obs/__init__.py", "obs/events.py", "obs/request.py",
            "faults/__init__.py", "faults/plan.py", "faults/proxy.py",
            "faults/resume_harness.py", "delivery/resilient.py",
            "engine/resilience.py", "utils/locks.py"} <= names
    for sub in ("obs", "faults"):
        for f in (PKG / sub).rglob("*.py"):
            assert not _FORBIDDEN.search(f.read_text()), f


def test_trainer_loads_neither_jax_nor_strom(tmp_path):
    """One uninterrupted trainer run with the module's import check: the
    trainer and the modules it pulls in (checkpoints, pipelines, faults)
    load no jax* or strom.* module."""
    shard = tmp_path / "tokens.bin"
    np.arange(96 * 64, dtype=np.int32).tofile(shard)
    code = (
        "import sys, runpy\n"
        "sys.argv = ['resume_harness', 'trainer', '--workdir', sys.argv[1],"
        " '--shard', sys.argv[2], '--steps', '6', '--ckpt-every', '2',"
        " '--fault-plan', 'chaos:1']\n"
        "try:\n"
        "    runpy.run_module('strom_torch.faults.resume_harness',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n"
        "assert 'strom_torch.faults.proxy' in sys.modules\n"
        "assert 'strom_torch.obs.request' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                           str(shard)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "meta_ref.json") as f:
        meta = json.load(f)
    assert meta["final_steps"] == 6 and meta["ckpt_commits"] == 2


@pytest.mark.parametrize("module", ["strom_torch.obs.chrome_trace",
                                    "strom_torch.obs.exemplars",
                                    "strom_torch.obs.stall",
                                    "strom_torch.obs.flight",
                                    "strom_torch.utils.locks",
                                    "strom_torch.utils.tracing",
                                    "strom_torch.engine.stress"])
def test_readers_witness_and_stress_load_no_jax_or_strom(module, tmp_path):
    """The span readers, the lock-order witness, the trace helper and the
    stress harness load neither jax* nor strom.*, also with the witness
    and a flight recorder on a context that reads."""
    shard = tmp_path / "d.bin"
    shard.write_bytes(bytes(range(256)) * 1024)
    code = (
        f"import sys, {module}\n"
        "from strom_torch.config import StromConfig\n"
        "from strom_torch.delivery.core import StromContext\n"
        "cfg = StromConfig(engine='python', debug_locks=True,"
        " flight_dir=sys.argv[2], flight_stall_s=0.0)\n"
        "with StromContext(cfg) as ctx:\n"
        "    assert bytes(ctx.pread(sys.argv[1], 0, 4096)) =="
        " bytes(range(256)) * 16\n"
        "    ctx.flight_recorder.dump('probe')\n"
        "    ctx.stats()['steps']\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(shard),
                           str(tmp_path / "fl")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_scan_covers_the_readers_witness_and_stress():
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    new = {"obs/chrome_trace.py", "obs/exemplars.py", "obs/stall.py",
           "obs/flight.py", "utils/locks.py", "utils/tracing.py",
           "engine/stress.py"}
    assert new <= names
    for name in new:
        assert not _FORBIDDEN.search((PKG / name).read_text()), name


@pytest.mark.parametrize("module", ["strom_torch.obs.slo",
                                    "strom_torch.obs.history",
                                    "strom_torch.obs.server",
                                    "strom_torch.obs.federation",
                                    "strom_torch.tune",
                                    "strom_torch.tune.knobs",
                                    "strom_torch.tune.autotuner"])
def test_observability_plane_and_tuner_load_no_jax_or_strom(module,
                                                            tmp_path):
    """The SLO engine, the history, the metrics server, the federation and
    the autotuner load neither jax* nor strom.*, also on a context that
    serves every route, federates itself and beats its tuner."""
    shard = tmp_path / "d.bin"
    shard.write_bytes(bytes(range(256)) * 1024)
    code = (
        f"import sys, urllib.request, {module}\n"
        "import strom_torch\n"
        "from strom_torch.config import StromConfig\n"
        "from strom_torch.delivery.core import StromContext\n"
        "cfg = StromConfig(engine='python', history_interval_s=0.05)\n"
        "with StromContext(cfg, metrics_port=0) as ctx:\n"
        "    assert bytes(ctx.pread(sys.argv[1], 0, 4096)) =="
        " bytes(range(256)) * 16\n"
        "    port = ctx.metrics_server.port\n"
        "    ctx.attach_cluster({'self': f'127.0.0.1:{port}'},"
        " interval_s=0.05)\n"
        "    ctx.attach_tuner(start=False).step()\n"
        "    for route in ('metrics', 'stats', 'trace', 'slo', 'tune',"
        " 'history', 'tenants', 'flight', 'cluster'):\n"
        "        with urllib.request.urlopen("
        "f'http://127.0.0.1:{port}/{route}', timeout=10) as r:\n"
        "            assert r.status == 200, route\n"
        "    assert '# TYPE strom_ssd2gpu_bytes counter' in"
        " strom_torch.prometheus()\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(shard)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_scan_covers_the_observability_plane_and_tuner():
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    new = {"obs/slo.py", "obs/history.py", "obs/server.py",
           "obs/federation.py", "tune/__init__.py", "tune/knobs.py",
           "tune/autotuner.py"}
    assert new <= names
    for name in new:
        assert not _FORBIDDEN.search((PKG / name).read_text()), name


@pytest.mark.parametrize("how", ["import", "help"])
def test_cli_loads_no_jax_or_strom(how):
    """``import strom_torch.cli`` and ``python -m strom_torch.cli --help``
    load no jax* or strom.* module."""
    check = ("bad = sorted(n for n in sys.modules if n.startswith("
             "('jax', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
             "assert not bad, bad\n")
    if how == "import":
        code = "import sys, strom_torch.cli\n" + check
    else:
        code = ("import sys, runpy\n"
                "sys.argv = ['strom_torch.cli', '--help']\n"
                "try:\n"
                "    runpy.run_module('strom_torch.cli', run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    assert e.code == 0, e.code\n" + check +
                "print('checked')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    if how == "help":
        assert "ssd2gpu" in proc.stdout and "checked" in proc.stdout
        # the script form too
        proc = subprocess.run([sys.executable, "-m", "strom_torch.cli",
                               "--help"], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and "daemon" in proc.stdout, proc.stderr


def test_scan_covers_the_cli_and_numa():
    """The source scan above reads the CLI and the NUMA module."""
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    new = {"cli.py", "utils/numa.py"}
    assert new <= names
    for name in new:
        assert not _FORBIDDEN.search((PKG / name).read_text()), name


@pytest.mark.parametrize("module", ["strom_torch.parallel.mesh",
                                    "strom_torch.parallel.sharding",
                                    "strom_torch.parallel.multihost",
                                    "strom_torch.delivery.shard"])
def test_mesh_modules_load_no_jax_or_strom(module, tmp_path):
    """The many-device modules load neither jax* nor strom.*, also with a
    world-1 group driving a sharded delivery, a data-parallel step, a
    straggler report and a group-summed scan."""
    shard = tmp_path / "t.bin"
    shard.write_bytes(np.arange(8 * 17, dtype=np.int32).tobytes())
    code = (
        f"import sys, {module}\n"
        "from strom_torch.config import StromConfig\n"
        "from strom_torch.delivery.core import StromContext\n"
        "from strom_torch.models.llama import LlamaConfig\n"
        "from strom_torch.parallel import mesh\n"
        "from strom_torch.parallel.multihost import StragglerMonitor\n"
        "from strom_torch.parallel.sharding import P, TorchSharding\n"
        "from strom_torch.parallel.train import (init_train_state,\n"
        "                                        make_train_step)\n"
        "mesh.init_distributed('cpu')\n"
        "m = mesh.make_mesh({'dp': 1})\n"
        "with StromContext(StromConfig(engine='python')) as ctx:\n"
        "    t = ctx.memcpy_ssd2gpu(sys.argv[1], shape=(8, 17),\n"
        "                           dtype='int32',\n"
        "                           sharding=TorchSharding(m, P('dp')))\n"
        "assert type(t).__name__ == 'DTensor', type(t)\n"
        "cfg = LlamaConfig.tiny()\n"
        "st = init_train_state(cfg, device='cpu', mesh=m)\n"
        "st, met = make_train_step(cfg, device='cpu', mesh=m)(st, t)\n"
        "assert met['loss'].isfinite()\n"
        "assert StragglerMonitor().report().hosts[0].steps == 0\n"
        "mesh.shutdown()\n"
        "bad = sorted(n for n in sys.modules if n.startswith(('jax', "
        "'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(shard)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_peer_fabric_loads_no_jax_or_strom(tmp_path):
    """The peer fabric (``strom_torch.dist``: the extent service, the
    ring, the launcher) loads neither jax* nor strom.*, also with one
    context serving another a peer hit, and its sources are scanned."""
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    new = {"dist/__init__.py", "dist/peers.py", "dist/directory.py",
           "dist/launch.py"}
    assert new <= names
    for name in new:
        assert not _FORBIDDEN.search((PKG / name).read_text()), name
    shard = tmp_path / "d.bin"
    shard.write_bytes(bytes(range(256)) * 1024)
    code = (
        "import sys, strom_torch.dist, strom_torch.dist.launch\n"
        "from strom_torch.config import StromConfig\n"
        "from strom_torch.delivery.core import StromContext\n"
        "cfg = StromConfig(engine='python', hot_cache_bytes=1 << 20,"
        " hot_cache_admit='always')\n"
        "with StromContext(cfg) as a, StromContext(cfg) as b:\n"
        "    addr = a.serve_peers()\n"
        "    a.pread(sys.argv[1], 0, 4096)\n"
        "    b.attach_peers({0: addr}, owner_fn=lambda p: 0)\n"
        "    assert bytes(b.pread(sys.argv[1], 0, 4096)) =="
        " bytes(range(256)) * 16\n"
        "    assert b.stats(['dist'])['dist']['peer_hit_bytes'] == 4096\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(shard)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_ring_and_tensor_parallel_load_no_jax_or_strom():
    """Ring attention and tensor parallelism (``parallel/ring.py``,
    ``parallel/tensor_parallel.py``) load neither jax* nor strom.*, also
    with a world-1 group running a sequence-parallel step over the flash
    ring, and their sources are scanned."""
    names = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    new = {"parallel/ring.py", "parallel/tensor_parallel.py"}
    assert new <= names
    for name in new:
        assert not _FORBIDDEN.search((PKG / name).read_text()), name
    code = (
        "import sys, torch, strom_torch.parallel.ring\n"
        "import strom_torch.parallel.tensor_parallel\n"
        "from strom_torch.models.llama import LlamaConfig\n"
        "from strom_torch.parallel import mesh\n"
        "from strom_torch.parallel.train import (init_train_state,\n"
        "                                        make_train_step)\n"
        "mesh.init_distributed('cpu')\n"
        "m = mesh.make_mesh({'dp': 1, 'tp': 1, 'sp': 1})\n"
        "cfg = LlamaConfig.tiny()\n"
        "st = init_train_state(cfg, device='cpu', mesh=m)\n"
        "step = make_train_step(cfg, attn='zigzag', device='cpu', mesh=m,\n"
        "                       sp=True)\n"
        "st, met = step(st, torch.randint(0, 512, (1, 32)))\n"
        "assert met['loss'].isfinite()\n"
        "mesh.shutdown()\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'strom' or n.startswith('strom.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
