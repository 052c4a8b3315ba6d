"""The bf16 training chain on the card against float64 and against other
summation orders of its plain version.

    python scripts/bf16_chain_f64.py [--n 328 123] [--seeds 0 1 2 ...]

Each case (N rows, a seed; seed 0 is the test's own, seeded N) runs the
chain of ``tests/test_torch_port_cuda.py::
test_bf16_chain_kernels_match_plain_and_launch`` (7 blocks, 768 -> 512,
dropout from block 3 with given masks) five ways, each h_L and the
gradients of the test's cotangent with respect to W and b:

* ``kernel``: ``fused_dense_chain`` (K5f, K5b and the tail pair in bf16);
* ``plain``: ``dense_chain_reference`` in bf16 on the card, the test's
  reference;
* ``plain_perm``: the same plain chain on the card with every hidden
  feature axis (and the input's) permuted at random, the weights, biases
  and masks permuted with it and the results put back: the same values and
  roundings, its GEMMs summed in another order;
* ``plain_cpu``: the plain bf16 chain on the CPU (another f32 GEMM);
* ``f64``: the plain chain in float64 on the CPU (the same bf16 input
  values, weights and masks, no rounding after the input).

For each of ``kernel``, ``plain_perm`` and ``plain_cpu`` against
``plain``, one JSON line a case: how many elements of h lie outside JAX's
bf16 tolerance of ``plain`` (rtol 0.05, atol 0.05) and, at those
elements, each chain's mean distance to float64 and at how many each is
the nearer; each chain's mean and largest distance to float64 over all
of h; the gradients' largest relative 2-norm distance to ``plain`` and
the largest ratio, over parameters, of a chain's distance to float64 to
``plain``'s. A last line a N pools the cases. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from contrastiveprosthetics_torch.ops import _build  # noqa: E402
from contrastiveprosthetics_torch.ops import train_fused as TF  # noqa: E402

L, D0, F = 7, 768, 512
DROPOUT_FROM = L - 4
OTHERS = ("kernel", "plain_perm", "plain_cpu")


def inputs(N: int, seed: int):
    """The test's inputs (numpy f32) for seed 0, else another draw."""
    rng = np.random.default_rng(N if seed == 0 else (N, seed))
    x0 = rng.standard_normal((N, D0)).astype(np.float32)
    ws = [(rng.uniform(-1, 1, (D0 if i == 0 else F, F)) / np.sqrt(D0))
          .astype(np.float32) for i in range(L)]
    bs = [rng.normal(0, 0.1, F).astype(np.float32) for _ in range(L)]
    masks = [(rng.random((N, F)) < 0.5).astype(np.float32) for _ in range(4)]
    cot = rng.standard_normal((N, F)).astype(np.float32)
    return x0, ws, bs, masks, cot


def permuted(case, perms):
    """The case with the input's features permuted by ``perms[0]`` and
    layer i's output features by ``perms[i + 1]``."""
    x0, ws, bs, masks, cot = case
    return (x0[:, perms[0]],
            [w[perms[i]][:, perms[i + 1]] for i, w in enumerate(ws)],
            [b[perms[i + 1]] for i, b in enumerate(bs)],
            # mask j drops layer (DROPOUT_FROM + j)'s outputs
            [m[:, perms[DROPOUT_FROM + 1 + j]] for j, m in enumerate(masks)],
            cot[:, perms[L]])


def chain(case, device, how: str):
    """h_L (f64 on the CPU) and the gradients of W then b."""
    x0, ws, bs, masks, cot = case
    dtype = torch.float64 if how == "f64" else torch.float32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    # the test casts its f32 input to bf16: every path starts from those
    x = torch.from_numpy(np.ascontiguousarray(x0)).to(torch.bfloat16).to(
        device)
    if how == "f64":
        x = x.double()
    w = [t(a).requires_grad_() for a in ws]
    b = [t(a).requires_grad_() for a in bs]
    g = [torch.ones(F, device=device, dtype=dtype).requires_grad_()
         for _ in range(L)]
    be = [torch.zeros(F, device=device, dtype=dtype).requires_grad_()
          for _ in range(L)]
    m = [t(a) for a in masks]
    if how == "kernel":
        h, _, _ = TF.fused_dense_chain(x, w, b, g, be, None, 0.5,
                                       mask_mode="input", ext_masks=m)
    else:
        keep = torch.full((1,), 0.5, device=device, dtype=dtype)
        h, _, _ = TF.dense_chain_reference(
            x, w, b, g, be, m, keep, dropout_from=DROPOUT_FROM,
            compute_dtype=(torch.float32 if how == "f64"
                           else torch.bfloat16))
    grads = torch.autograd.grad((h.to(dtype) * t(cot)).sum(), w + b)
    return (h.double().cpu().detach(), [a.double().cpu() for a in grads])


def run(N: int, seed: int) -> dict[str, tuple]:
    case = inputs(N, seed)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    out = {"kernel": chain(case, cuda, "kernel"),
           "plain": chain(case, cuda, "plain"),
           "plain_cpu": chain(case, cpu, "plain"),
           "f64": chain(case, cpu, "f64")}
    rng = np.random.default_rng((N, seed, 1))
    perms = [rng.permutation(D0)] + [rng.permutation(F) for _ in range(L)]
    h, grads = chain(permuted(case, perms), cuda, "plain")
    inv = [np.argsort(p) for p in perms]
    out["plain_perm"] = (
        h[:, inv[L]],
        [gw[inv[i]][:, inv[i + 1]] for i, gw in enumerate(grads[:L])]
        + [gb[inv[i + 1]] for i, gb in enumerate(grads[L:])])
    return out


def compare(out: dict, other: str) -> dict:
    h, grads = out[other]
    hp, gp = out["plain"]
    h64, g64 = out["f64"]
    apart = (h - hp).abs() > 0.05 + 0.05 * hp.abs()
    d_o, d_p = (h - h64).abs(), (hp - h64).abs()
    return dict(
        outside=int(apart.sum()),
        at_outside=dict(
            to_f64_mean=float(d_o[apart].mean()) if apart.any() else None,
            plain_to_f64_mean=(float(d_p[apart].mean()) if apart.any()
                               else None),
            sum_to_f64=float(d_o[apart].sum()),
            plain_sum_to_f64=float(d_p[apart].sum()),
            nearer=int((d_o[apart] < d_p[apart]).sum()),
            plain_nearer=int((d_p[apart] < d_o[apart]).sum())),
        h_to_f64=dict(mean=float(d_o.mean()), max=float(d_o.max())),
        grad_vs_plain=max(float((a - b).norm() / b.norm())
                          for a, b in zip(grads, gp)),
        grad_to_f64_ratio=max(float((a - c).norm() / (b - c).norm())
                              for a, b, c in zip(grads, gp, g64)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[328, 123])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    _build.build(("train_fused",))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for N in args.n:
        pooled = {o: dict(outside=0, sum_to_f64=0.0, plain_sum_to_f64=0.0,
                          nearer=0, plain_nearer=0, grad_vs_plain=0.0,
                          grad_to_f64_ratio=0.0, share=0.0)
                  for o in OTHERS}
        for seed in args.seeds:
            out = run(N, seed)
            line = dict(N=N, seed=seed, elements=out["plain"][0].numel(),
                        plain_h_to_f64=dict(
                            mean=float((out["plain"][0] - out["f64"][0])
                                       .abs().mean()),
                            max=float((out["plain"][0] - out["f64"][0])
                                      .abs().max())))
            for o in OTHERS:
                c = line[o] = compare(out, o)
                p = pooled[o]
                p["outside"] += c["outside"]
                p["share"] = max(p["share"], c["outside"] / line["elements"])
                for k in ("sum_to_f64", "plain_sum_to_f64", "nearer",
                          "plain_nearer"):
                    p[k] += c["at_outside"][k]
                for k in ("grad_vs_plain", "grad_to_f64_ratio"):
                    p[k] = max(p[k], c[k])
            print(json.dumps(line), flush=True)
        for p in pooled.values():
            p["mean_ratio_at_outside"] = (p["sum_to_f64"]
                                          / p["plain_sum_to_f64"]
                                          if p["outside"] else None)
        print(json.dumps(dict(N=N, seeds=args.seeds, pooled=pooled)),
              flush=True)


if __name__ == "__main__":
    main()
