"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, no source of it imports either, and with no device given and no
CUDA present its entry points raise instead of running on the CPU."""

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
