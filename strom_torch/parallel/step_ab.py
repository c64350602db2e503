"""Time the train steps, or the delivery paths, of several checkouts of
this repo on one card, in turns, so two versions are compared on the same
card in the same call.

    python3 -m strom_torch.parallel.step_ab DIR [DIR ...]
    python3 -m strom_torch.parallel.step_ab --delivery [--sched-rounds N] DIR [DIR ...]
    python3 -m strom_torch.parallel.step_ab --loaders DIR [DIR ...]

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
instead. ``--loaders`` drives only the host-bound delivery paths, with no
train step: phase 5's streamed gather (``[stream]``) and the loaders
alone over phase 7's tar of 512 448-pixel JPEGs, the ResNet one at batch
128 streamed and not (``[ab_resnet_jpeg_streamed]``,
``[ab_resnet_jpeg_barrier]``) and the ViT one at batch 64 over the tar
striped on 4 members (``[ab_vit_jpeg]``), 4 batches each from a dropped
page cache, each line's ``images_per_s``. Host-side times move from call to call, and within one call
with the call's age, so only checkouts run in one call compare, in an
order that alternates (parent, change, change, parent). Needs one CUDA
device.
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
    elif sys.argv[2] == "loaders":
        import numpy as np
        import strom_torch
        from strom_torch.config import StromConfig

        path = os.path.join(workdir, "stream.bin")
        cs._write_file(path, np.frombuffer(
            bytearray(np.random.default_rng(0).bytes(cs.GiB)), np.uint8))
        cs.phase_stream(path)
        os.unlink(path)
        tar = os.path.join(workdir, "imagenet.tar")
        cs._jpeg_fixture(tar, 512, 448)
        cuda = torch.device("cuda")
        ctx = strom_torch.init(StromConfig.from_env())
        for streamed in (True, False):
            cs._drop_cache(tar)
            pipe = cs.make_imagenet_resnet_pipeline(
                ctx, [tar], batch=128, device=cuda,
                stream_intra_batch=streamed)
            cs._loader_alone("ab_resnet_jpeg_" + ("streamed" if streamed
                                                  else "barrier"),
                             pipe, 4, 128)
            pipe.close()
        chunk = StromConfig().raid_chunk
        members = cs._stripe_members(tar, 4, chunk)
        walias = tar + ".raid0"
        ctx.register_striped(walias, members, chunk, size=os.path.getsize(tar))
        for m in members:
            cs._drop_cache(m)
        pipe = cs.make_vit_wds_pipeline(ctx, [walias], batch=64,
                                        image_size=cs.IMAGE, device=cuda)
        cs._loader_alone("ab_vit_jpeg", pipe, 4, 64)
        pipe.close()
        strom_torch.close()
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
    ap.add_argument("--loaders", action="store_true",
                    help="phase 5's streamed gather and the JPEG loaders "
                         "alone, no train step")
    ap.add_argument("--sched-rounds", type=int, default=4,
                    help="rounds of phase 3's [sched] arms (--delivery)")
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    mode = "delivery" if args.delivery else \
        "loaders" if args.loaders else "train"
    rc = 0
    for root in args.dirs:
        rc |= subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(root), mode,
                              str(args.sched_rounds)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
