"""The port's kill/restart harness, as the JAX package's is tested: a
trainer SIGKILLed at a seeded mid-epoch step restarts from its last
committed checkpoint and StepToken (``Pipeline.token`` / ``restore``) and
continues the exact batch stream, with no epoch replay and no orphaned
tmp checkpoint; also under a fault plan's op window over the kill step.
The SIGTERM and warm-hint cases are marked slow, as the JAX package's
are."""

import json
import os

import pytest

from strom_torch.ckpt.jobstate import RESUME_FIELDS
from strom_torch.faults import run_kill_resume
from strom_torch.utils.stats import global_stats


def _assert_contract(out: dict) -> None:
    assert out["failures"] == [], f"harness contract broke: {out['failures']}"
    assert out["resume_ok"] == 1
    assert 0 < out["resume_restart_step"] <= out["resume_kill_step"] + 1
    assert 0 <= out["resume_replayed_batches"] <= 8
    assert out["resume_batches_checked"] > 0
    assert set(RESUME_FIELDS) <= set(out)


def test_sigkill_mid_epoch_bit_identical_resume(tmp_path):
    out = run_kill_resume(str(tmp_path), seed=1)
    _assert_contract(out)
    assert global_stats.gauge("resume_ok").value == 1
    assert global_stats.gauge("resume_kill_step").value \
        == out["resume_kill_step"]
    # no tmp checkpoint survives the cycle
    leftovers = [n for n in os.listdir(tmp_path)
                 if n.startswith("ckpt.tmp-") or n.startswith("ckpt.old-")]
    assert leftovers == []


def test_fault_rule_op_window_over_kill_step(tmp_path):
    """Transient read faults around the kill and restart: retries absorb
    them and the contract still holds."""
    plan = json.dumps({"seed": 4, "rules": [
        {"kind": "errno", "op": "read", "op_lo": 8, "op_hi": 160,
         "p": 0.05, "times": 6, "err": "EIO"},
        {"kind": "short_read", "op": "read", "op_lo": 8, "op_hi": 160,
         "p": 0.05, "times": 6, "short_frac": 0.5},
        {"kind": "latency", "op": "read", "op_lo": 8, "op_hi": 160,
         "p": 0.2, "times": 20, "latency_s": 0.002},
    ]})
    out = run_kill_resume(str(tmp_path), seed=2, fault_plan=plan)
    _assert_contract(out)


@pytest.mark.slow
def test_sigterm_variant(tmp_path):
    out = run_kill_resume(str(tmp_path), seed=3, sig="TERM")
    _assert_contract(out)


@pytest.mark.slow
def test_warm_hints_travel_with_the_token(tmp_path):
    out = run_kill_resume(str(tmp_path), seed=5, warm_hints=True,
                          cache_bytes=4 << 20)
    _assert_contract(out)
    assert (out.get("resume_warm_bytes") or 0) > 0


def test_too_few_batches_raises(tmp_path):
    with pytest.raises(ValueError, match="too few"):
        run_kill_resume(str(tmp_path), records=16, batch=4, ckpt_every=4)
