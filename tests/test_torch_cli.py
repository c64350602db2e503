"""The port's benchmark CLI (``strom_torch/cli.py``) held to the JAX
package's (``strom/cli.py``) on the CPU: the same arguments through both
packages' arm functions (the port's with ``device="cpu"``, both on the
preadv pool), at the sizes the reference's own tests use. Compared: the
JSON keys, byte counts and Parquet counts exactly; rates are this host's
and are not compared. Also the parsers' option strings and defaults, the
``all`` matrix's failure rule, the daemon's signal contract, and the list
of deliberate differences."""

import argparse
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

import strom.cli as jcli
import strom_torch.cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


def _ns(**kw) -> argparse.Namespace:
    base = dict(file=None, size=4 * MiB, block=128 * 1024, depth=8, iters=1,
                engine="python", json=True)
    base.update(kw)
    return argparse.Namespace(**base)


def _both(fn_name: str, tmp_path, port_fn=None, **kw) -> tuple[dict, dict]:
    """*fn_name* of each package on the same arguments, each in a tmpdir of
    its own (the fixtures are generated from the same seeds)."""
    out = {}
    for pkg, mod in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        extra = {"device": "cpu"} if pkg == "torch" else {}
        fn = getattr(mod, port_fn if (pkg == "torch" and port_fn)
                     else fn_name)
        out[pkg] = fn(_ns(tmpdir=str(d), **kw, **extra))
    return out["jax"], out["torch"]


# ---------------------------------------------------------------- byte arms
@pytest.mark.parametrize("raid", [0, 4])
def test_ssd2host_matches_reference(tmp_path, raid):
    """bench_ssd2host, plain and --raid 4 on 4 MiB: the same keys, the
    exact bytes, 2 passes (tests/test_delivery.py's shape); the port's
    striped alias reads the source bytes."""
    n = 4 * MiB
    data = np.random.default_rng(5).integers(0, 256, n, dtype=np.uint8)
    p = tmp_path / "ratio.bin"
    data.tofile(p)
    kw = dict(file=str(p), size=n, iters=2)
    if raid:
        kw.update(raid=raid, raid_chunk=64 * 1024)
    j, t = _both("bench_ssd2host", tmp_path, **kw)
    assert set(t) == set(j)
    for k in ("bench", "bytes", "block", "depth", "passes", "engine",
              "raid_members"):
        assert t[k] == j[k], k
    assert t["bytes"] == n and t["passes"] == 2
    assert len(t["raw_gbps_passes"]) == len(t["host_gbps_passes"]) == 2
    assert t["raw_gbps"] == max(t["raw_gbps_passes"])
    assert t["host_gbps"] == max(t["host_gbps_passes"])
    if raid:
        from strom_torch.config import StromConfig
        from strom_torch.delivery.core import StromContext

        members, _ = tcli._ensure_striped(str(p), raid, 64 * 1024)
        with StromContext(StromConfig(engine="python")) as ctx:
            ctx.register_striped(str(p) + ".raid0", members, 64 * 1024,
                                 size=n)
            np.testing.assert_array_equal(
                ctx.memcpy_ssd2host(str(p) + ".raid0", length=n), data)


@pytest.mark.parametrize("numa_node", [-1, 0])
def test_nvme_matches_reference(tmp_path, numa_node):
    """bench_nvme: the same keys, bytes and numa_node (node 0 only where
    sysfs shows it)."""
    if numa_node == 0 and not os.path.isdir(
            "/sys/devices/system/node/node0"):
        pytest.skip("no sysfs NUMA topology")
    before = os.sched_getaffinity(0)
    try:
        j, t = _both("bench_nvme", tmp_path, buffered=False, huge=False,
                     numa_node=numa_node, per_op=False, sqpoll=False)
    finally:
        os.sched_setaffinity(0, before)
    assert set(t) == set(j)
    for k in ("bench", "bytes", "block", "depth", "o_direct", "iters",
              "per_op", "numa_node", "huge", "warm", "file_created"):
        assert t[k] == j[k], k
    assert t["bytes"] == 4 * MiB and t["numa_node"] == numa_node


def test_nvme_per_op_and_huge_read_exact(tmp_path):
    """--per-op rides read_into_direct, --huge a MAP_HUGETLB slab where
    pages are reserved (normal pages else): both read every byte."""
    t = tcli.bench_nvme(_ns(tmpdir=str(tmp_path), buffered=False, huge=True,
                            numa_node=-1, per_op=True, sqpoll=False))
    assert t["bytes"] == 4 * MiB and t["per_op"] and t["huge"]


def test_ssd2gpu_matches_reference_ssd2tpu(tmp_path):
    """ssd2gpu (the reference's ssd2tpu) on the CPU: the reference's keys
    and byte count; only the bench name and device differ."""
    j, t = _both("bench_ssd2tpu", tmp_path, port_fn="bench_ssd2gpu",
                 chunk=MiB, prefetch=2)
    assert set(t) == set(j)
    assert (j["bench"], t["bench"]) == ("ssd2tpu", "ssd2gpu")
    assert t["bytes"] == j["bytes"] == 4 * MiB
    assert t["device"] == "cpu"


def test_arms_raise_without_cuda_or_device(tmp_path):
    """No CPU path unless asked for: without --device and without CUDA the
    delivering arms raise."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.bench_ssd2gpu(_ns(tmpdir=str(tmp_path), chunk=MiB, prefetch=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["llama", "--tmpdir", str(tmp_path), "--steps", "1",
                   "--batch", "1", "--seq-len", "63", "--json"])


@pytest.mark.parametrize("missing", [False, True])
def test_check_matches_reference(tmp_path, capsys, missing):
    """check: the same JSON for the same file; a missing file exits 2."""
    p = tmp_path / "c.bin"
    if not missing:
        np.random.default_rng(2).integers(0, 256, MiB,
                                          dtype=np.uint8).tofile(p)
    rcs, outs = [], []
    for mod in (jcli, tcli):
        rcs.append(mod.main(["check", str(p), "--json"]))
        outs.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1] == (2 if missing else 0)
    if not missing:
        assert json.loads(outs[0]) == json.loads(outs[1])


# ------------------------------------------------------------------ parquet
@pytest.mark.parametrize("case", [
    dict(rows=20_000, row_groups=4, prefetch=2, unit_batch=1, raid=0,
         raid_chunk=512 * 1024, columns=4, compression="none",
         dtype="float32", disk_rate=True, cpu_device=True),
    dict(rows=20_000, row_groups=4, prefetch=2, unit_batch=2, raid=2,
         raid_chunk=64 * 1024, columns=4, compression="none",
         dtype="float32", disk_rate=True, cpu_device=True),
    dict(rows=20_000, row_groups=4, prefetch=2, unit_batch=1, raid=0,
         raid_chunk=512 * 1024, pushdown=True, cpu_device=True),
], ids=["plain_disk_rate", "raid_disk_rate", "snappy_pushdown"])
def test_parquet_matches_reference(tmp_path, case):
    """bench_parquet (tests/test_pipelines.py's shapes): the same keys,
    rows, row groups, selected columns and hit counts, exactly, and the
    pushdown A/B's counts; the decode route as the reference's."""
    j, t = _both("bench_parquet", tmp_path, size=0, block=4096, **case)
    assert set(t) == set(j)
    for k in ("bench", "rows", "row_groups", "hits", "selected_columns",
              "raid_members", "compression", "unit_batch"):
        assert t[k] == j[k], k
    assert (t["plain_decoded_bytes"] > 0) == (j["plain_decoded_bytes"] > 0)
    assert (t["pyarrow_decoded_bytes"] > 0) == \
        (j["pyarrow_decoded_bytes"] > 0)
    if case.get("disk_rate"):
        assert len(t["disk_gbps_passes"]) == 2
        assert t["vs_disk"] is not None and t["vs_disk"] > 0
    if case.get("pushdown"):
        for k in ("pushdown_ok", "pushdown_hits", "unpushed_hits",
                  "pushdown_rows", "parquet_pushdown_groups_skipped",
                  "parquet_pushdown_groups_total"):
            assert t[k] == j[k], k
        assert t["pushdown_ok"] == 1


def test_parquet_scan_on_the_default_device_needs_cuda(tmp_path):
    """Without --cpu-device or --device the scan's map runs on the card:
    here it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.bench_parquet(_ns(tmpdir=str(tmp_path), size=0, rows=2000,
                               row_groups=2, prefetch=1, unit_batch=1,
                               raid=0, raid_chunk=512 * 1024,
                               compression="none"))


# ------------------------------------------------------- helpers and keys
def test_decode_counters_and_cache_keys_match_reference():
    """``_DECODE_COUNTERS`` is the reference's tuple, and
    ``_cache_epoch_phases`` produces exactly ``CACHE_BENCH_FIELDS``."""
    from strom.delivery.hotcache import CACHE_BENCH_FIELDS

    assert tcli._DECODE_COUNTERS == jcli._DECODE_COUNTERS

    class _Pipe:
        class sampler:
            batches_per_epoch = 2

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def __next__(self):
            return np.zeros((2, 4, 4, 3), np.uint8), np.zeros(2, np.int32)

    class _Ctx:
        hot_cache = None

    got = tcli._cache_epoch_phases(_Ctx(), lambda **kw: _Pipe(), 2, [])
    assert tuple(got) == CACHE_BENCH_FIELDS
    assert got["cache_epoch_steps"] == 2


def test_vision_arms_match_reference_keys(tmp_path):
    """bench_resnet with the hot cache and bench_vit predecoded, a few
    batches of a small tar: the reference's keys (the decode pair's
    native epochs only where each package's binding exists)."""
    import strom.formats.jpeg as jjpeg
    import strom_torch.formats.jpeg as tjpeg

    pytest.importorskip("cv2")
    kw = dict(batch=4, image_size=32, steps=2, prefetch=2,
              decode_workers=2, train_step=False)
    j, t = _both("bench_resnet", tmp_path, hot_cache_bytes=64 * MiB, **kw)
    native = {"decode_native_img_per_s", "decode_cv2_img_per_s",
              "decode_native_vs_cv2", "decode_native_imgs",
              "decode_native_fallbacks", "decode_fused_runs",
              "decode_fused_samples", "decode_roi_hits",
              "decode_roi_rows_skipped"}
    if jjpeg.native_available() == tjpeg.native_available():
        assert set(t) == set(j)
    else:
        assert set(t) - native == set(j) - native
    assert t["cache_epoch_steps"] == j["cache_epoch_steps"]
    j, t = _both("bench_vit", tmp_path, raid=4, raid_chunk=64 * 1024,
                 predecoded=True, **kw)
    assert set(t) == set(j)
    assert t["raid_members"] == j["raid_members"] == 4


def test_llama_train_step_matches_reference(tmp_path):
    """llama --model tiny --train-step, two steps at S 127: the same keys
    and the same token counts; the port's arm runs one device."""
    kw = dict(batch=2, seq_len=127, steps=2, prefetch=2, train_step=True,
              model="tiny", attn="dense")
    j, t = _both("bench_llama", tmp_path, **kw)
    assert set(t) == set(j)
    for k in ("bench", "batch", "seq_len", "steps", "train_model",
              "train_attn", "steps_observed"):
        assert t[k] == j[k], k
    assert t["devices"] == 1
    assert np.isfinite(t["train_loss"])
    assert t["tokens_per_s"] > 0 and t["train_tokens_per_s"] > 0


@pytest.mark.parametrize("arm,kw", [
    ("bench_checkpoint", dict(model="tiny")),
    ("bench_chaos", dict(batch=4, image_size=32, steps=2, prefetch=2,
                         decode_workers=2, seed=0)),
    ("bench_multitenant", dict(batch=4, image_size=32, steps=2,
                               rows=20_000, pq_iters=1)),
], ids=["checkpoint", "chaos", "multitenant"])
def test_state_and_tenant_arms_match_reference_keys(tmp_path, arm, kw):
    """checkpoint (--model tiny), chaos and multitenant at small shapes:
    the reference's keys; the checkpoint round trip exact and the spill
    epoch with no source miss, the faulted pass equal to the clean one."""
    pytest.importorskip("cv2")
    j, t = _both(arm, tmp_path, **kw)
    assert set(t) == set(j)
    if arm == "bench_checkpoint":
        assert t["ckpt_roundtrip_ok"] == j["ckpt_roundtrip_ok"] == 1
        assert t["spill_cache_miss_bytes"] == j["spill_cache_miss_bytes"] == 0
    elif arm == "bench_chaos":
        assert t["chaos_ok"] == j["chaos_ok"] == 1
        assert t["fault_plan"] == j["fault_plan"] == "chaos:0"
    else:
        assert t["mt_tenants"] == j["mt_tenants"] == ["vis0", "vis1", "pq"]


# ------------------------------------------------------------ the matrix
def _stub(name):
    def fn(args):
        if name == "resnet" and not getattr(args, "predecoded", False):
            raise RuntimeError("patched to fail")
        return {"bench": name}
    return fn


@pytest.mark.parametrize("mod", [jcli, tcli], ids=["jax", "torch"])
def test_all_names_a_failed_phase_and_exits_3(tmp_path, capsys,
                                               monkeypatch, mod):
    """One phase patched to raise: the others still run, it alone is in
    ``failed`` with its error, and main exits 3 (in both packages)."""
    names = ("bench_nvme", "bench_ssd2host", "bench_llama", "bench_resnet",
             "bench_vit", "bench_parquet",
             "bench_ssd2tpu" if mod is jcli else "bench_ssd2gpu")
    for n in names:
        monkeypatch.setattr(mod, n, _stub(n.split("_", 1)[1]))
    rc = mod.main(["all", "--json", "--tmpdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 3
    assert out["failed"] == ["resnet"]
    assert "patched to fail" in out["resnet"]["error"]
    byte = "ssd2tpu" if mod is jcli else "ssd2gpu"
    assert [k for k in out if k not in ("bench", "failed")] == [
        "nvme", "ssd2host", "ssd2host_raid", byte, "llama", "resnet",
        "resnet_predecoded", "vit", "parquet", "parquet_raid0",
        "parquet_wide", "parquet_plain"]


# ------------------------------------------------------------ the parsers
class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser *main* builds (caught at parse_args)."""
    def grab(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        main(["check", "x"])
    monkeypatch.undo()
    return e.value.args[0]


def _options(parser) -> dict:
    """{subcommand: ({option strings: (dest, default, type, choices,
    nargs, const, action)}, set_defaults without fn)}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        opts = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            opts[tuple(a.option_strings) or (a.dest,)] = (
                a.dest, a.default, getattr(a.type, "__name__", a.type),
                tuple(a.choices) if a.choices else None, a.nargs, a.const,
                type(a).__name__)
        out[name] = (opts, {k: v for k, v in p._defaults.items()
                            if k != "fn"})
    return out


def test_every_subcommand_has_the_reference_options(monkeypatch):
    """Every subcommand of the reference, ``dist`` included, has the same
    option strings, dests, defaults, types and choices in the port, save
    the listed differences (``ssd2tpu`` → ``ssd2gpu``, ``--device``)."""
    ref = _options(_parser_of(jcli.main, monkeypatch))
    port = _options(tcli.build_parser())
    ref["ssd2gpu"] = ref.pop("ssd2tpu")
    assert set(port) == set(ref)
    for name, (opts, defaults) in ref.items():
        popts, pdefaults = port[name]
        if "--file" in {s for k in opts for s in k}:
            # the common flags carry --device
            dev = popts.pop(("--device",))
            assert dev[:2] == ("device", None), name
        assert popts == opts, name
        assert pdefaults == defaults, name


def test_help_lists_every_subcommand_but_dist(capsys):
    """The help lists every subcommand; since the peer fabric is ported,
    ``dist`` among them."""
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for name in ("nvme", "ssd2host", "ssd2gpu", "llama", "resnet", "vit",
                 "parquet", "all", "multitenant", "chaos", "checkpoint",
                 "resume", "tune", "daemon", "check"):
        assert name in text, name
    assert "dist" in text.split("positional arguments")[1].split(
        "options:")[0]


def test_deliberate_differences(tmp_path):
    """Every deliberate difference from the reference, in one place:
    ``ssd2tpu`` is ``ssd2gpu``, the arms take ``--device``, without a
    process group the arms run one device, ``tune`` adds the searched
    state's own rate, and ``dist --mode mesh`` runs one process a card
    (a ``--devices-per-proc`` other than 1 raises)."""
    sub = next(a for a in tcli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction)).choices
    assert "ssd2gpu" in sub and "ssd2tpu" not in sub and "dist" in sub
    assert callable(tcli.bench_dist)
    with pytest.raises(ValueError, match="one process a card"):
        tcli.main(["dist", "--mode", "mesh", "--devices-per-proc", "2",
                   "--procs", "1", "--steps", "1", "--batch", "2",
                   "--records", "4", "--seq-len", "16", "--files", "1",
                   "--engine", "python", "--tmpdir", str(tmp_path)])
    assert all(any("--device" in a.option_strings for a in p._actions)
               for n, p in sub.items() if n not in ("check", "daemon"))
    assert tcli._fit_dp_devices(32) == 1
    kw = dict(size=4 * MiB, cache_bytes=MiB, trials=2, profile="",
              metrics_port=0)
    j, t = _both("bench_tune", tmp_path, **kw)
    assert set(t) - set(j) == {"searched_items_per_s", "searched_vs_hand"}
    assert set(j) <= set(t)
    assert t["tuned_vs_hand"] >= 1.0


def test_fit_dp_devices_is_the_world_or_refuses(monkeypatch):
    """With a group the batch splits over every process, and a world that
    does not divide it is refused (the reference would take the largest
    device count that divides it)."""
    from strom_torch.parallel import mesh

    assert tcli._fit_dp_devices(3) == 1   # no group: one device
    monkeypatch.setattr(mesh, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    assert tcli._fit_dp_devices(32) == 2
    with pytest.raises(ValueError, match="does not split over 2"):
        tcli._fit_dp_devices(3)


_LLAMA_ARGS = ["llama", "--train-step", "--model", "tiny", "--attn", "dense",
               "--batch", "4", "--seq-len", "31", "--steps", "2", "--device",
               "cpu", "--engine", "python", "--json"]


def _launch_two(target: list[str], tmp_path, timeout: float,
                args: list[str] = _LLAMA_ARGS) -> dict:
    """``torch.distributed.run`` of *target* (``-m strom_torch.cli`` or a
    script) with an arm's arguments (the llama arm's by default) on two
    gloo ranks; returns the one JSON line, which rank 0 alone prints. Past
    *timeout* the launcher gets SIGTERM, which it passes on to its ranks
    (each runs in a session of its own)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *target, *args, "--tmpdir",
         str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        stdout, stderr = proc.communicate(timeout=60)
        raise AssertionError(f"no result within {timeout} s:\n"
                             f"{stderr[-3000:]}") from None
    assert proc.returncode == 0, stderr[-3000:]
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


def test_llama_launched_on_two_processes(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    strom_torch.cli llama --train-step ... --device cpu``: two gloo ranks
    split the batch, train data-parallel, and rank 0 alone prints the
    JSON, whose ``devices`` is 2."""
    out = _launch_two(["-m", "strom_torch.cli"], tmp_path, 300)
    assert out["devices"] == 2 and out["batch"] == 4
    assert np.isfinite(out["train_loss"]) and out["train_tokens_per_s"] > 0


@pytest.mark.parametrize("arm", ["resnet", "vit"])
def test_vision_arm_launched_on_two_processes(tmp_path, arm):
    """``torch.distributed.run --nproc-per-node 2 -m strom_torch.cli
    <resnet|vit> --predecoded --train-step ... --device cpu``: the two
    ranks read their rows of each batch, step data-parallel (ResNet's
    batch norm over the global batch), and rank 0 prints ``devices`` 2
    and a finite loss."""
    out = _launch_two(
        ["-m", "strom_torch.cli"], tmp_path, 300,
        [arm, "--predecoded", "--train-step", "--model", "tiny",
         "--batch", "4", "--image-size", "32", "--steps", "2",
         "--prefetch", "4", "--device", "cpu", "--engine", "python",
         "--json"])
    assert out["devices"] == 2 and out["batch"] == 4
    assert np.isfinite(out["train_loss"]) and out["train_images_per_s"] > 0


_LATE_RANK1 = """\
import runpy, sys, time
from strom_torch.parallel import mesh
init, delay = mesh.init_distributed, float(sys.argv.pop(1))

def late_rank1(*a, **kw):
    init(*a, **kw)
    if mesh.rank() == 1:   # rank 0 writes and closes the fixture meanwhile
        time.sleep(delay)

mesh.init_distributed = late_rank1
sys.argv[0] = "strom_torch.cli"
runpy.run_module("strom_torch.cli", run_name="__main__")
"""


def test_llama_launched_with_a_late_rank(tmp_path):
    """Rank 1 joins the group, then waits 3 s: rank 0 has written the
    token fixture by the time rank 1 reaches it, and both still meet at
    the fixture's barrier (rank 0 alone decides whether the file is
    short), so the launched arm finishes with ``devices`` 2."""
    script = tmp_path / "late_rank1.py"
    script.write_text(_LATE_RANK1)
    out = _launch_two([str(script), "3"], tmp_path, 120)
    assert out["devices"] == 2 and np.isfinite(out["train_loss"])


# -------------------------------------------------------------- the daemon
@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT],
                         ids=["term", "int"])
def test_daemon_registers_drains_and_dies_by_the_signal(tmp_path, sig):
    """``python -m strom_torch.cli daemon`` (tests/test_sched.py's run of
    the reference's): the ready line, a tenant registered over POST
    /tenants, then the signal drains every tenant (``stuck=[]``) and the
    process ends by the signal; SIGTERM leaves a flight bundle."""
    fdir = str(tmp_path / "flight")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    p = subprocess.Popen(
        [sys.executable, "-m", "strom_torch.cli", "daemon",
         "--metrics-port", "0", "--engine", "python",
         "--flight-dir", fdir, "--drain-timeout", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        ready = p.stdout.readline()
        assert "strom daemon ready" in ready, ready
        port = int(ready.split("port=")[1].split()[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tenants",
            data=json.dumps({"op": "register", "name": "ext",
                             "priority": "interactive"}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.load(r)["name"] == "ext"
        p.send_signal(sig)
        out, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=10)
    assert "strom daemon drained tenants=" in out, out
    assert "stuck=[]" in out, out
    assert p.returncode == -sig, (p.returncode, out)
    if sig == signal.SIGTERM:
        assert any("sigterm" in b for b in os.listdir(fdir))
