"""The embedding gradients behind ``test_torch_ep.QUIET_G``: for a case of
``tests/test_torch_ep.py``, the JAX package's gradient of each batch at
the initial parameters on the case's mesh and on one device, and the
port's in one process, with the final embedding each would give under
AdamW (two steps, the first at lr 0, in f64). Prints how far the three
gradients lie apart (every element, and the quiet ones), the quiet
elements' count and the final gaps.

    JAX_PLATFORMS=cpu python tests/ep_quiet_grads.py dp2ep2_cf125
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import gloo_ranks  # noqa: E402
import test_torch_ep as ep  # noqa: E402
from strom.models import moe as jmoe  # noqa: E402
from strom.parallel import train as jtrain  # noqa: E402
from strom.parallel.mesh import make_mesh  # noqa: E402
from strom_torch.models import moe as tmoe  # noqa: E402
from strom_torch.parallel.train import warmup_cosine  # noqa: E402


def adamw(grads, p0, wd=0.1, b1=0.9, b2=0.999, eps=1e-8):
    m = v = 0.0
    p = p0.astype(np.float64)
    for t, g in enumerate(grads):
        lr = gloo_ranks.LR * warmup_cosine(t, warmup=gloo_ranks.WARMUP)
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        mh, vh = m / (1 - b1 ** (t + 1)), v / (1 - b2 ** (t + 1))
        p = p - lr * (mh / (np.sqrt(vh) + eps) + wd * p)
    return p


def main(cid: str) -> None:
    _, axes, _, _, cf = ep.CASES[cid]
    cfg = ep._cfg(jmoe, cf)
    mesh = make_mesh(axes, devices=jax.devices()[:ep.WORLD])
    init = jtrain.init_moe_train_state(
        jax.random.PRNGKey(0), cfg, mesh,
        jtrain.make_optimizer(lr=gloo_ranks.LR, warmup=gloo_ranks.WARMUP))
    params = jax.tree_util.tree_map(np.asarray, init.params)
    grad = jax.jit(jax.grad(jmoe.next_token_loss), static_argnums=2)
    batches = ep._batches()
    on_mesh = [np.asarray(grad(init.params, jnp.asarray(b), cfg)["embed"])
               for b in batches]
    one = jax.tree_util.tree_map(jnp.asarray, params)
    on_one = [np.asarray(grad(one, jnp.asarray(b), cfg)["embed"])
              for b in batches]
    model = tmoe.MoE(ep._cfg(tmoe, cf), device="cpu")
    model.load_state_dict(tmoe.params_from_jax(params))
    port = []
    for b in batches:
        model.zero_grad()
        tmoe.next_token_loss(model, torch.from_numpy(b), remat=True).backward()
        port.append(model.embed.grad.numpy().copy())
    g = np.max(np.abs(on_mesh), axis=0)
    quiet = (g > 0) & (g < ep.QUIET_G)
    final = {k: adamw([x.astype(np.float64) for x in v], params["embed"])
             for k, v in (("mesh", on_mesh), ("one", on_one),
                          ("port", port))}
    print(f"{cid}: quiet {int(quiet.sum())} of {g.size}")
    for k, v in (("one", on_one), ("port", port)):
        d = np.abs(np.array(v) - np.array(on_mesh))
        gap = np.abs(final[k] - final["mesh"])
        print(f"  {k} against the mesh: gradient apart up to {d.max():.3g} "
              f"(quiet {d[:, quiet].max(initial=0):.3g}); final embedding "
              f"apart up to {gap[quiet].max(initial=0):.3g} on the quiet "
              f"elements, {gap[~quiet].max():.3g} on the rest")


if __name__ == "__main__":
    for cid in sys.argv[1:] or list(ep.CASES):
        main(cid)
