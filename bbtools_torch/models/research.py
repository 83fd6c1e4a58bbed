"""calibrate and regressiontrainer, from the JAX package's research
launchers (research.py).

The PyTorch port of bbtools_tpu/models/research.py's calibrate_main
(calibrate.sh -> ml.Calibrate) and regressiontrainer_main
(regressiontrainer.sh -> ml.RegressionTrainer, which is train). The
calibration fits p = K*sigmoid(a*logit(x)+b)^c to (score, label) rows by
plain gradient descent, torch autograd on the run's device (`device=`,
cuda by default). The JAX package runs with x64 on: its logits and
labels are float64 and its four parameters float32, so the model and
the loss compute in float64 while the gradients and the update stay
float32; torch's promotion of a 0-dim float32 tensor against a float64
one gives the same. `calibrate_fit.device_calls` counts fits on CUDA.
The other launchers of that module do no device work (ROADMAP A8b).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.parser import tokenize
from ..device import resolve_device


def calibrate_fit(x: np.ndarray, y: np.ndarray, epochs: int, lr: float, device):
    """`epochs` gradient steps on mean((K*sigmoid(a*logit(x)+b)^exp(logc)
    - y)^2) from a=1, b=0, K=1, logc=0; returns ({name: float32
    parameter}, the float64 loss after the last step)."""
    dev = resolve_device(str(device))
    if dev.type == "cuda":
        calibrate_fit.device_calls += 1
    xl = torch.log(torch.as_tensor(x / (1 - x), dtype=torch.float64, device=dev))
    yt = torch.as_tensor(y, dtype=torch.float64, device=dev)

    def loss(p):
        s = torch.sigmoid(p["a"] * xl + p["b"])
        return torch.mean((p["K"] * s ** torch.exp(p["logc"]) - yt) ** 2)

    p = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in (("a", 1.0), ("b", 0.0), ("K", 1.0), ("logc", 0.0))}
    for _ in range(epochs):
        for v in p.values():
            v.requires_grad_(True)
        grads = torch.autograd.grad(loss(p), list(p.values()))
        with torch.no_grad():
            p = {k_: v - lr * g for (k_, v), g in zip(p.items(), grads)}
    with torch.no_grad():
        mse = float(loss(p))
    return {k_: v.cpu().numpy() for k_, v in p.items()}, mse


#: fits on CUDA since the count was last set to 0
calibrate_fit.device_calls = 0


def calibrate_main(args):
    """ml.Calibrate: fit p = K*sigmoid(a*logit(x)+b)^c on (score,label)
    rows by gradient descent (torch, on the device)."""
    a = tokenize(args)
    device = resolve_device(a.get("device", default="cuda"))
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: calibrate in=<tsv: score label> [out=constants]"
              " [epochs=2000]", file=sys.stderr)
        return 1
    from ..io.readwrite import read_bytes

    xs, ys = [], []
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        f = ln.split(b"\t")
        xs.append(float(f[0]))
        ys.append(float(f[1]))
    x = np.clip(np.array(xs), 1e-6, 1 - 1e-6)
    y = np.array(ys)
    lr = float(a.get("lr", default="0.05"))
    epochs = int(a.get("epochs", default="2000"))
    p, mse = calibrate_fit(x, y, epochs, lr, device)
    c = float(np.exp(float(p["logc"])))
    line = (f"a={float(p['a']):.5f}\tb={float(p['b']):.5f}"
            f"\tK={float(p['K']):.5f}\tc={c:.5f}\tmse={mse:.6f}")
    out = a.get("out", "out1")
    if out:
        with open(out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


def regressiontrainer_main(args):
    """ml.RegressionTrainer: continuous-output net, MSE+Adam (the
    shared jax trainer already is Adam; linear output head)."""
    from .mltools import train_main

    return train_main(args)
