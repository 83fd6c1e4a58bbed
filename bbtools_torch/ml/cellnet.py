"""CellNet — the reference's tiny dense MLP runtime, on torch.

The PyTorch port of bbtools_tpu/ml/cellnet.py. Reference: ml/CellNet.java
(feedForwardDense :763), ml/CellNetParser.java (.bbnet text format:
header `#dims a b c...`, then `C<id> TYPE bias w...` per cell, dense
concise layout), ml/Functions.java activations:
  SIG 1/(1+e^-x) (:23), TANH (:126), RSLOG sign(x)*log(|x|+1) (:241),
  MSIG mirrored sigmoid (offset 5, xmult 2, ymult 1/sig(5), :292-323),
  SWISH x*sig(x) (:170), ESIG 2*sig(x)-1 (:61), EMSIG 2*mSig(x)-1,
  BELL e^(-x^2), LINEAR.

A layer is one float32 [out, in] matmul over the whole batch on the
net's device (`device`, cuda by default); mixed per-cell activations
inside a layer are a select over the activation types, in the JAX
package's order of operations. The parser and writer are host copies.

Training (`fit`) is full-batch Adam over the mean squared error on the
net's device: torch.autograd gives the gradient through the same
forward, and the Adam step is written out in optax.adam's order (the JAX
package's optimizer), not with torch.optim.Adam, which groups its terms
otherwise. float32 products differ between XLA and torch (C4), and
training compounds that over the epochs, so the nets agree within a
tolerance, not bit for bit. `CellNet.fit.device_calls` counts fits on
CUDA and `CellNet.forward.device_calls` forward passes on CUDA.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device

TYPES = ["SIG", "TANH", "RSLOG", "MSIG", "SWISH", "ESIG", "EMSIG", "BELL",
         "LINEAR"]
_MSIG_OFF = 5.0
_MSIG_XMULT = 2.0
_MSIG_YMULT = float(1.0 / (1.0 / (1.0 + np.exp(-_MSIG_OFF))))
#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _activations(x, types):
    """Apply per-cell activations; x [..., n] float32, types int [n]
    (an array, or a tensor on x's device)."""
    sig = 1.0 / (1.0 + torch.exp(-x))
    msig = torch.where(
        x < 0,
        1.0 / (1.0 + torch.exp(-(_MSIG_XMULT * x + _MSIG_OFF))),
        1.0 / (1.0 + torch.exp(_MSIG_XMULT * x - _MSIG_OFF)),
    ) * _MSIG_YMULT
    outs = [
        sig,
        torch.tanh(x),
        torch.sign(x) * torch.log(torch.abs(x) + 1.0),
        msig,
        x * sig,
        2.0 * sig - 1.0,
        2.0 * msig - 1.0,
        torch.exp(-(x * x)),
        x,
    ]
    t = types if torch.is_tensor(types) else torch.as_tensor(np.asarray(types), device=x.device)
    result = outs[0]
    for i in range(1, len(outs)):
        result = torch.where(t == i, outs[i], result)
    return result


@dataclass
class CellNet:
    dims: list
    weights: list  # per layer: [out, in] float32
    biases: list  # per layer: [out]
    types: list  # per layer: int array [out]
    cutoff: float = 0.5
    header: dict = field(default_factory=dict)
    #: where forward/apply run: cuda or cpu
    device: str = "cuda"

    def forward(self, x):
        """x [B, dims[0]] -> output [B, dims[-1]] (float32 tensor)."""
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            CellNet.forward.device_calls += 1
        h = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        for W, b, t in zip(self.weights, self.biases, self.types):
            z = h @ torch.as_tensor(W, device=dev).T + torch.as_tensor(b, device=dev)
            h = _activations(z, t)
        return h

    def apply(self, x) -> np.ndarray:
        return self.forward(np.atleast_2d(x)).cpu().numpy()

    def classify(self, x) -> np.ndarray:
        return self.apply(x)[:, 0] >= self.cutoff

    def fit(self, x, y, epochs=2000, lr=0.05, seed=0):
        """`epochs` full-batch Adam steps on mean((net(x) - y)^2) from the
        net's float32 weights, on its device; `seed` is unused, as in the
        JAX package. Each step is optax.adam(lr)'s: mu = (1-b1)*g + b1*mu;
        nu = (1-b2)*g^2 + b2*nu; then -lr * (mu / (1-b1^t)) /
        (sqrt(nu / (1-b2^t)) + eps), added to the parameter. The bias
        corrections are 0-dim float32 tensors on the device, so each
        division is a true division, as XLA's is (CUDA divides by a host
        scalar as a product with its reciprocal). Returns the last step's
        loss, taken before that step's update."""
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            CellNet.fit.device_calls += 1
        nl = len(self.weights)
        params = [torch.tensor(np.asarray(p, np.float32), device=dev, requires_grad=True)
                  for p in (*self.weights, *self.biases)]
        types_t = [torch.as_tensor(np.asarray(t), device=dev) for t in self.types]
        x_t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        y_t = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        steps = np.arange(1, epochs + 1, dtype=np.float64)
        corr1 = torch.tensor(1 - ADAM_B1 ** steps, dtype=torch.float32, device=dev)
        corr2 = torch.tensor(1 - ADAM_B2 ** steps, dtype=torch.float32, device=dev)
        loss = None
        for t in range(epochs):
            h = x_t
            for W, b, ty in zip(params[:nl], params[nl:], types_t):
                h = _activations(h @ W.T + b, ty)
            loss = torch.mean((h - y_t) ** 2)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
                    v.copy_((1 - ADAM_B2) * g ** 2 + ADAM_B2 * v)
                    p.add_(-lr * ((m / corr1[t]) / (torch.sqrt(v / corr2[t]) + ADAM_EPS)))
        out = [p.detach().cpu().numpy() for p in params]
        self.weights, self.biases = out[:nl], out[nl:]
        return float(loss.detach())

    @classmethod
    def create(cls, dims, seed=0, hidden="SIG", out="SIG"):
        rng = np.random.default_rng(seed)
        ws, bs, ts = [], [], []
        for i in range(1, len(dims)):
            fan = dims[i - 1]
            ws.append(
                rng.normal(0, 1.0 / np.sqrt(fan), (dims[i], fan)).astype(
                    np.float32
                )
            )
            bs.append(np.zeros(dims[i], np.float32))
            name = out if i == len(dims) - 1 else hidden
            ts.append(np.full(dims[i], TYPES.index(name), np.int32))
        return cls(list(dims), ws, bs, ts)


#: forward passes on CUDA since the count was last set to 0
CellNet.forward.device_calls = 0

#: fits on CUDA since the count was last set to 0
CellNet.fit.device_calls = 0


def _open(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _a48_to_float(tok: str) -> float:
    """ByteBuilder.appendFloatA48 inverse: big-endian 6-bit symbols
    (chr+48) of the float's raw 32-bit pattern."""
    v = 0
    for ch in tok:
        v = (v << 6) | (ord(ch) - 48)
    return float(
        np.uint32(v & 0xFFFFFFFF).view(np.float32)
    )


def parse_bbnet(path: str) -> CellNet:
    """Parse a dense concise .bbnet file (CellNetParser.java layout),
    decimal or `#coding A48` float coding."""
    dims = None
    header = {}
    cutoff = 0.5
    cells = {}
    a48 = False
    with _open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##ctf") or line.startswith("#ctf"):
                cutoff = float(line.split()[-1])
            elif line.startswith("##"):
                key = line[2:].split(None, 1)
                if key:
                    header[key[0]] = key[1] if len(key) > 1 else ""
                continue
            elif line.startswith("#"):
                parts = line.split(None, 1)
                key = parts[0][1:]
                header[key] = parts[1] if len(parts) > 1 else ""
                if key == "dims":
                    dims = [int(v) for v in parts[1].split()]
                elif key == "coding":
                    a48 = parts[1].strip().upper() == "A48"
            elif line[0] in "CW":
                f = line.split()
                cid = int(f[0][1:])
                typ = TYPES.index(f[1].upper())
                if a48:
                    vals = np.array(
                        [_a48_to_float(v) for v in f[2:]], np.float32
                    )
                else:
                    vals = np.array([float(v) for v in f[2:]], np.float32)
                cells[cid] = (typ, vals[0], vals[1:])
    if dims is None:
        raise ValueError(f"{path}: no #dims header")
    weights, biases, types = [], [], []
    cid = dims[0] + 1  # cell ids start at 1 (CellNet.java:311 reserves 0)
    for li in range(1, len(dims)):
        n_out, n_in = dims[li], dims[li - 1]
        W = np.zeros((n_out, n_in), np.float32)
        b = np.zeros(n_out, np.float32)
        t = np.zeros(n_out, np.int32)
        for j in range(n_out):
            typ, bias, w = cells[cid]
            if len(w) != n_in:
                raise ValueError(
                    f"cell C{cid}: {len(w)} weights, expected {n_in}"
                )
            W[j] = w
            b[j] = bias
            t[j] = typ
            cid += 1
        weights.append(W)
        biases.append(b)
        types.append(t)
    return CellNet(dims, weights, biases, types, cutoff, header)


def save_bbnet(net: CellNet, path: str) -> None:
    lines = ["##bbnet", "#version 1", "#concise", "#dense",
             f"#layers {len(net.dims)}",
             "#dims " + " ".join(str(d) for d in net.dims),
             f"##ctf {net.cutoff:.6f}",
             "#edges %d" % sum(w.size for w in net.weights)]
    cid = net.dims[0] + 1
    for W, b, t in zip(net.weights, net.biases, net.types):
        lines.append(f"##layer")
        for j in range(W.shape[0]):
            ws = " ".join(f"{v:.6f}" for v in W[j])
            lines.append(f"C{cid} {TYPES[int(t[j])]} {b[j]:.6f} {ws}")
            cid += 1
    data = "\n".join(lines) + "\n"
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            fh.write(data)
    else:
        with open(path, "w") as fh:
            fh.write(data)
