"""The port's Prometheus text held to the JAX package's: two registries fed
the same seeded counters, gauges, histograms and scopes render equal text,
line for line; the sections exposition of one nested dict is equal too;
``all_counter_names`` sees every live registry and forgets a dead one; and
``strom_torch.prometheus()`` carries the process context's sections."""

import gc
import re

import numpy as np
import pytest

import strom_torch
from strom.utils import stats as jstats
from strom_torch.config import StromConfig
from strom_torch.utils import stats as tstats

PKGS = {"jax": jstats, "torch": tstats}


def _feed(mod, seed: int):
    """A registry of *mod* fed one seeded stream: counters, gauges (one a
    bool), histograms, and two label scopes writing through."""
    rng = np.random.default_rng(seed)
    reg = mod.StatsRegistry("strom")
    for i in range(6):
        reg.add(f"bytes_{i}", int(rng.integers(0, 1 << 30)))
    reg.set_gauge("depth", 7)
    reg.set_gauge("ratio", 0.25)
    reg.set_gauge("flag", True)
    for us in rng.exponential(300.0, size=200):
        reg.observe_us("read_latency", float(us))
    t0 = reg.scoped(tenant="t0", pipeline="resnet")
    t1 = reg.scoped(tenant='we"ird\\name\n')
    for us in rng.exponential(50.0, size=40):
        t0.observe_us("read_latency", float(us))
    t0.add("bytes_0", 5)
    t1.add("bytes_1", 9)
    t1.set_gauge("depth", 3)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_equal_line_for_line(seed):
    texts = {k: _feed(mod, seed).prometheus() for k, mod in PKGS.items()}
    assert texts["torch"].splitlines() == texts["jax"].splitlines()
    lines = texts["torch"].splitlines()
    assert "# TYPE strom_read_latency_us histogram" in lines
    assert "# TYPE strom_bytes_0 counter" in lines
    assert "# TYPE strom_depth gauge" in lines
    assert any(ln.startswith('strom_bytes_0{pipeline="resnet",tenant="t0"}')
               for ln in lines)
    # a newline in a label value is escaped: no sample spans two lines
    assert all(ln.startswith(("#", "strom_")) for ln in lines)


def test_histogram_block_is_cumulative_and_counts_match():
    text = _feed(tstats, 3).prometheus()
    # the unlabelled family only (scoped samples carry more labels)
    bucket = [ln for ln in text.splitlines()
              if re.match(r'strom_read_latency_us_bucket\{le="[^"]+"\} ', ln)]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in bucket]
    assert counts == sorted(counts)
    count_line = [ln for ln in text.splitlines()
                  if ln.startswith("strom_read_latency_us_count ")][0]
    assert int(count_line.split()[1]) == counts[-1] == 240


def test_sections_text_equal():
    sections = {"context": {"ssd2gpu_bytes": 5, "registered_files": 2,
                            "coalesce_ops_in_last": 3},
                "engine": {"engine": "python", "ops_submitted": 11,
                           "read_latency_hist": [1, 2, 0, 4],
                           "read_latency_total_us": 99.5,
                           "read_latency_p50_us": 4.0,
                           "read_latency_count": 7},
                "scopes": {"tenant=\"a\"": {"x": 1}},
                "bare": 3}
    counters = frozenset({"ssd2gpu_bytes", "ops_submitted"})
    texts = {k: mod.sections_prometheus(sections, counters=counters)
             for k, mod in PKGS.items()}
    assert texts["torch"] == texts["jax"]
    assert "# TYPE strom_context_ssd2gpu_bytes counter" in texts["torch"]
    assert "strom_engine_read_latency_us_count 7" in texts["torch"]


def test_all_counter_names_follows_live_registries():
    reg = tstats.StatsRegistry("probe")
    reg.add("only_in_the_probe_registry_xyz")
    assert "only_in_the_probe_registry_xyz" in tstats.all_counter_names()
    del reg
    gc.collect()
    assert "only_in_the_probe_registry_xyz" not in tstats.all_counter_names()


def test_scopes_snapshot_and_counter_names_match():
    regs = {k: _feed(mod, 4) for k, mod in PKGS.items()}
    assert regs["torch"].scopes_snapshot() == regs["jax"].scopes_snapshot()
    assert regs["torch"].counter_names() == regs["jax"].counter_names()


def test_top_level_prometheus_carries_the_context_sections(data_file):
    path, golden = data_file
    strom_torch.close()
    strom_torch.init(StromConfig(engine="python"))
    try:
        got = strom_torch.memcpy_ssd2host(path, length=1 << 20)
        assert bytes(got) == golden[: 1 << 20].tobytes()
        text = strom_torch.prometheus()
    finally:
        strom_torch.close()
    assert "# TYPE strom_ssd2gpu_bytes counter" in text
    assert "# TYPE strom_context_ssd2gpu_bytes counter" in text
    assert "strom_context_registered_files 1" in text.splitlines()
    assert any(ln.startswith("strom_engine_ops_submitted ")
               for ln in text.splitlines())
    # the scopes section is the registry's labelled samples, not a section
    assert "strom_scopes" not in text
