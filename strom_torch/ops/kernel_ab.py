"""Time the flash kernels of several checkouts of this repo on one card, in
turns, so two versions are compared on the same card in the same call.

    python3 -m strom_torch.ops.kernel_ab [--shape B,S,H,KV,Dh] [--dtype bf16|f32] DIR [DIR ...]

Each DIR is a checkout: this repo's root, or an older commit unpacked
with ``git archive``. Each runs in its own process, in the order given
(parent, change, change, parent for an A/B), builds its own kernels with
its own ``chip_smoke.py`` and prints one JSON line: the checkout, the card
and its power limit, nvcc's register and spill report of every kernel
instantiation, and each kernel's median, min and max ms over 5 runs, causal, at
``--shape`` and ``--dtype`` (default: the main path's, B 2, S 2048, H 32,
KV 8, Dh 128, bf16; f32 runs the scalar kernels): ``ms`` as
that checkout's own ``chip_smoke`` times a call (host and device, as a
caller sees it), and ``device_ms`` with the launches queued behind a sleep
on the card, so the host's dispatch never leaves the card idle between
them. Beside them, SDPA's forward and backward (dq, dk and dv) on the same
inputs with TF32 off, as that checkout's ``chip_smoke`` times SDPA: the
yardstick the port never calls. Needs one CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import json, os, re, subprocess, sys
import torch
root = sys.argv[1]
shape = tuple(int(x) for x in sys.argv[2].split(","))
dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[sys.argv[3]]
os.chdir(root)
sys.path.insert(0, root)
import chip_smoke as cs
from strom_torch.ops import build
from strom_torch.ops import flash_attention as fa

build.build_all()
if hasattr(cs, "ptxas_report"):
    regs = [dict(source=name, **entry) for name, log in build.build_logs.items()
            for entry in cs.ptxas_report(log)]
else:
    regs = [f"{name}: {line.strip()}" for name, log in build.build_logs.items()
            for line in log.splitlines() if "registers" in line or "spill" in line]
q, k, v, g = cs._inputs(*shape, dtype, 0)
_, lse, delta = cs._run_kernels(q, k, v, g, True)
calls = {
    "fa_fwd": lambda: fa._flash_fwd_kernel(q, k, v, causal=True),
    "fa_bwd_dkv": lambda: fa._bwd_dkv_kernel(q, k, v, g, lse, delta, causal=True),
    "fa_bwd_dq": lambda: fa._bwd_dq_kernel(q, k, v, g, lse, delta, causal=True),
}


def device_ms(fn, iters=10):
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)    # ~50 ms: every launch queues behind it
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spread(fn):
    runs = sorted(device_ms(fn) for _ in range(5))
    return [runs[2], runs[0], runs[-1]]


torch.backends.cuda.matmul.allow_tf32 = False
qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
sdpa_fwd = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
    qh, kh, vh, is_causal=True, enable_gqa=True)
sdpa_bwd_ms, sdpa_note = cs._sdpa_bwd_ms(q, k, v, g, 5)
smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True)
print(json.dumps({"checkout": root, "card": smi.stdout.strip(),
                  "shape": shape, "dtype": sys.argv[3],
                  "ms": {n: cs.cuda_ms_spread(f, 10) for n, f in calls.items()},
                  "device_ms": {n: spread(f) for n, f in calls.items()},
                  "sdpa_ms": {"fwd": cs.cuda_ms_spread(sdpa_fwd, 5)[0],
                              "bwd": sdpa_bwd_ms, "bwd_note": sdpa_note},
                  "ptxas": regs}), flush=True)
"""


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="2,2048,32,8,128",
                    help="B,S,H,KV,Dh")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    rc = 0
    for root in args.dirs:
        rc |= subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(root), args.shape,
                              args.dtype]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
