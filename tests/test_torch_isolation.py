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
from strom_torch.formats.rawbin import write_token_shard
from strom_torch.models.llama import Llama, LlamaConfig
from strom_torch.parallel.train import init_train_state, make_train_step
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline

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
    write_token_shard(path, np.arange(4 * 17, dtype=np.int32), fsync=False)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    ctx = StromContext()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctx.memcpy_ssd2gpu(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_llama_pipeline(ctx, [path], batch=2, seq_len=16)
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
