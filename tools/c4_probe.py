"""CPU probe of ROADMAP C4: why the port's CellNet (bbtools_torch/ml/
cellnet.py) cannot give the JAX package's scores bit for bit.

    JAX_PLATFORMS=cpu python tools/c4_probe.py [--net NAME] [--rows N]

On N random rows (20,000 by default) through a bundled net
(callvars_illumina_hap_dip.bbnet by default), layer by layer from the
JAX package's own hidden state, it counts the elements where:
  - the pre-activation z = h @ W.T + b differs between the JAX package's
    jitted product and torch's, and where a plain sequential float32 sum
    differs from each;
  - on the same z, each activation type of the layer differs between
    the JAX package's jitted `_activations` and the port's, with the
    largest difference in units in the last place.
It prints one JSON line a layer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in float32 units in the last place (same-sign values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", default="callvars_illumina_hap_dip.bbnet")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import torch

    from bbtools_torch.ml import cellnet as tnet
    from bbtools_tpu.ml import cellnet as jnet

    net = jnet.parse_bbnet(os.path.join(HERE, "bbtools_tpu", "resources", args.net))
    rng = np.random.default_rng(args.seed)
    h = rng.random((args.rows, net.dims[0])).astype(np.float32)
    act_j = jax.jit(jnet._activations, static_argnums=1)
    for layer, (W, b, t) in enumerate(zip(net.weights, net.biases, net.types)):
        W = np.asarray(W, np.float32)
        b = np.asarray(b, np.float32)
        zj = np.asarray(jax.jit(lambda x: x @ jnp.asarray(W).T + jnp.asarray(b))(h))
        zt = (torch.from_numpy(h) @ torch.from_numpy(W).T + torch.from_numpy(b)).numpy()
        zs = np.zeros_like(zj)  # a plain sequential float32 sum, then the bias
        for k in range(W.shape[1]):
            zs = (zs + h[:, k:k + 1] * W[None, :, k]).astype(np.float32)
        zs = (zs + b).astype(np.float32)
        types = np.asarray(t)
        aj = np.asarray(act_j(jnp.asarray(zj), tuple(types.tolist())))
        at = tnet._activations(torch.from_numpy(np.array(zj)), types).numpy()
        per_type = {}
        for k in np.unique(types):
            cols = types == k
            d = ulps(aj[:, cols], at[:, cols])
            per_type[jnet.TYPES[k]] = {"differ": float((d > 0).mean()), "max_ulp": int(d.max())}
        print(json.dumps({
            "layer": layer, "shape": list(W.shape),
            "matmul_differ": float((zj != zt).mean()),
            "sequential_vs_jax": float((zs != zj).mean()),
            "sequential_vs_torch": float((zs != zt).mean()),
            "activations": per_type}))
        h = aj
    return 0


if __name__ == "__main__":
    sys.exit(main())
