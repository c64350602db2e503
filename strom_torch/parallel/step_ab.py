"""Time the train steps, or the delivery paths, of several checkouts of
this repo on one card, in turns, so two versions are compared on the same
card in the same call.

    python3 -m strom_torch.parallel.step_ab DIR [DIR ...]
    python3 -m strom_torch.parallel.step_ab --delivery [--sched-rounds N] DIR [DIR ...]

Each DIR is a checkout: this repo's root, or an older commit unpacked
with ``git archive``. Each runs in its own process, in the order given
(parent, change, parent, change for an A/B), and drives the three train
phases of its own ``chip_smoke.py``: phase 4 (Llama-3-8B widths, 2
layers, flash, AdamW), phase 6 (ResNet-50, batch 128) and phase 8
(ViT-B/16, batch 64, without the JPEG arm). Each prints its own
``[train]``, ``[resnet]``, ``[vit]`` and ``[profile]`` lines, after one
``[step_ab]`` line naming the checkout, the card and its power limit:
steady step ms, device busy ms and idle share, as that checkout measures
them. ``--delivery`` drives phases 3 (the 1 GiB delivery beside the
engine alone, and where the checkout has them the ``[sched]`` arms, N
alternating rounds of the scheduler on and off), 5 (the streamed gather),
6 (the predecoded loader and ResNet-50) and 7 (the JPEG-fed ResNet-50)
instead. Host-side step times move from call to call, so only checkouts
run in one call compare. Needs one CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import os, shutil, subprocess, sys
root = sys.argv[1]
os.chdir(root)
sys.path.insert(0, root)
import torch
import chip_smoke as cs

smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True)
cs.say("step_ab", checkout=root, card=smi.stdout.strip().replace(" ", "_"))
workdir = os.path.join(root, ".step_ab")
os.makedirs(workdir, exist_ok=True)
try:
    if sys.argv[2] == "delivery":
        cs.SCHED_ROUNDS = int(sys.argv[3])
        path = cs.phase_ssd2gpu(workdir)
        cs.phase_stream(path)
        os.unlink(path)
        model, step, pdec = cs.phase_resnet(workdir)
        cs.phase_resnet_jpeg(workdir, model, step)
    else:
        cs.phase_train(workdir)
        model, step, pdec = cs.phase_resnet(workdir)
        del model, step
        torch.cuda.empty_cache()
        cs.phase_vit(pdec, None)
finally:
    shutil.rmtree(workdir, ignore_errors=True)
"""


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--delivery", action="store_true",
                    help="phases 3, 5, 6 and 7 in place of the train phases")
    ap.add_argument("--sched-rounds", type=int, default=4,
                    help="rounds of phase 3's [sched] arms (--delivery)")
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    mode = "delivery" if args.delivery else "train"
    rc = 0
    for root in args.dirs:
        rc |= subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(root), mode,
                              str(args.sched_rounds)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
