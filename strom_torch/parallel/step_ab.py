"""Time the train steps, or the delivery paths, of several checkouts of
this repo on one card, in turns, so two versions are compared on the same
card in the same call.

    python3 -m strom_torch.parallel.step_ab DIR [DIR ...]
    python3 -m strom_torch.parallel.step_ab --delivery [--sched-rounds N] DIR [DIR ...]
    python3 -m strom_torch.parallel.step_ab --loaders [--loader-batches N]
        [--sample-ms MS] DIR[:served] [DIR[:served] ...]
    python3 -m strom_torch.parallel.step_ab --spill DIR [DIR ...]

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
striped on 4 members (``[ab_vit_jpeg]``), each ``--loader-batches``
batches (4 by default) from a dropped page cache, each line's
``images_per_s``, and a ``[step_ab] loader=`` line with the process's CPU
ms an image. ``--spill`` drives phase 7e's pread pair alone, at the
checkout's own ``SPILL_PREAD_BYTES`` with compression off and then on,
each with a ``[step_ab] spill_pread_bytes=`` line of its seconds. ``--sample-ms`` samples every other thread's innermost
Python frame that often beside each loader and prints the 40 most caught
(``[step_ab] sample=``). A checkout written ``DIR:served`` runs those
loaders on a context that serves its live endpoint (``metrics_port=0``,
history every 0.5 s) while a scraper process reads every route once and
then ``/metrics?sections=context,sched`` at 20 Hz; the scraper prints its
count on exit. Host-side times move from call to call, and within one call
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
    elif sys.argv[2] == "spill":
        import time
        import numpy as np

        toks = np.random.default_rng(7).integers(
            0, 1 << 15, cs.SPILL_PREAD_BYTES // 4, dtype=np.int32)
        for compress in (False, True):
            t0 = time.perf_counter()
            cs._spill_pread_arm(workdir, toks, compress)
            cs.say("step_ab", spill_pread_bytes=toks.nbytes,
                   compress=compress, s=f"{time.perf_counter() - t0:.1f}")
    elif sys.argv[2] == "loaders":
        import collections, threading, time
        import numpy as np
        import strom_torch
        from strom_torch.config import StromConfig

        batches, served = int(sys.argv[4]), sys.argv[5] == "served"
        sample_ms = float(sys.argv[6])
        loader_alone = cs._loader_alone

        def _frames(stop, leaf):
            # each other thread's innermost Python frame, every sample_ms
            me = threading.get_ident()
            while not stop.wait(sample_ms / 1e3):
                names = {t.ident: t.name.rstrip("0123456789_-")
                         for t in threading.enumerate()}
                for tid, f in sys._current_frames().items():
                    if tid != me:
                        code = f.f_code
                        leaf[(names.get(tid, "?"),
                              f"{os.path.basename(code.co_filename)}:"
                              f"{f.f_lineno}:{code.co_name}")] += 1

        def _measured(label, pipe, n, B):
            # the process's CPU time (every thread's) a delivered image:
            # the host work the loader did, apart from what it waited on;
            # with sample_ms, the frames each thread was caught in
            stop, leaf = threading.Event(), collections.Counter()
            sampler = threading.Thread(target=_frames, args=(stop, leaf),
                                       daemon=True)
            if sample_ms > 0:
                sampler.start()
            c0, t0 = time.process_time(), time.perf_counter()
            try:
                loader_alone(label, pipe, n, B)
            finally:
                cpu, wall = time.process_time() - c0, time.perf_counter() - t0
                stop.set()
                if sample_ms > 0:
                    sampler.join()
            cs.say("step_ab", loader=label,
                   cpu_ms_per_img=f"{cpu * 1e3 / (n * B):.4f}",
                   cpu_busy_cores=f"{cpu / wall:.3f}")
            for (who, where), c in leaf.most_common(40):
                cs.say("step_ab", sample=label, thread=who, frame=where,
                       samples=c)

        cs._loader_alone = _measured
        path = os.path.join(workdir, "stream.bin")
        cs._write_file(path, np.frombuffer(
            bytearray(np.random.default_rng(0).bytes(cs.GiB)), np.uint8))
        cs.phase_stream(path)
        os.unlink(path)
        tar = os.path.join(workdir, "imagenet.tar")
        cs._jpeg_fixture(tar, 512, 448)
        cuda = torch.device("cuda")
        scraper = None
        if served:
            from strom_torch.delivery.core import StromContext

            ctx = StromContext(StromConfig.from_env(history_interval_s=0.5),
                               metrics_port=0)
            scraper = subprocess.Popen([sys.executable, "-c", sys.argv[7],
                                        str(ctx.metrics_server.port)])
        else:
            ctx = strom_torch.init(StromConfig.from_env())
        cs.say("step_ab", served=served, batches=batches)
        for streamed in (True, False):
            cs._drop_cache(tar)
            pipe = cs.make_imagenet_resnet_pipeline(
                ctx, [tar], batch=128, device=cuda,
                stream_intra_batch=streamed)
            cs._loader_alone("ab_resnet_jpeg_" + ("streamed" if streamed
                                                  else "barrier"),
                             pipe, batches, 128)
            pipe.close()
        chunk = StromConfig().raid_chunk
        members = cs._stripe_members(tar, 4, chunk)
        walias = tar + ".raid0"
        ctx.register_striped(walias, members, chunk, size=os.path.getsize(tar))
        for m in members:
            cs._drop_cache(m)
        pipe = cs.make_vit_wds_pipeline(ctx, [walias], batch=64,
                                        image_size=cs.IMAGE, device=cuda)
        cs._loader_alone("ab_vit_jpeg", pipe, batches, 64)
        pipe.close()
        if scraper is not None:
            scraper.terminate()
            scraper.wait(timeout=30)
            ctx.close()
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


# the served loaders' scraper, a process of its own as a Prometheus server
# would be: every route once, then /metrics?sections=context,sched at 20 Hz
SCRAPER = r"""
import signal, sys, time, urllib.error, urllib.request
port = sys.argv[1]
n, codes = 0, set()
def get(route):
    global n
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as r:
            r.read()
            codes.add(r.status)
    except urllib.error.HTTPError as e:
        codes.add(e.code)
    n += 1
def done(*_):
    print(f"[step_ab] scrapes={n} codes={sorted(codes)}", flush=True)
    sys.exit(0)
signal.signal(signal.SIGTERM, done)
for r in ("/metrics", "/stats", "/trace", "/slo", "/history", "/tenants",
          "/flight"):
    get(r)
while True:
    get("/metrics?sections=context,sched")
    time.sleep(0.05)
"""


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--delivery", action="store_true",
                    help="phases 3, 5, 6 and 7 in place of the train phases")
    ap.add_argument("--loaders", action="store_true",
                    help="phase 5's streamed gather and the JPEG loaders "
                         "alone, no train step")
    ap.add_argument("--spill", action="store_true",
                    help="phase 7e's pread pair alone, compression off "
                         "and on")
    ap.add_argument("--sched-rounds", type=int, default=4,
                    help="rounds of phase 3's [sched] arms (--delivery)")
    ap.add_argument("--loader-batches", type=int, default=4,
                    help="batches each loader delivers (--loaders)")
    ap.add_argument("--sample-ms", type=float, default=0.0,
                    help="with --loaders: sample every thread's innermost "
                         "frame this often beside each loader and print "
                         "the 40 most caught")
    ap.add_argument("dirs", nargs="+",
                    help="checkouts; with --loaders, DIR:served runs the "
                         "loaders on a context serving its live endpoint "
                         "(history every 0.5 s) beside a scraper process")
    args = ap.parse_args()
    mode = "delivery" if args.delivery else \
        "loaders" if args.loaders else "spill" if args.spill else "train"
    rc = 0
    for entry in args.dirs:
        root, _, how = entry.partition(":")
        rc |= subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(root), mode,
                              str(args.sched_rounds),
                              str(args.loader_batches),
                              how or "plain", str(args.sample_ms),
                              SCRAPER]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
