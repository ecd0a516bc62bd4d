#!/usr/bin/env python3
"""Digests of kernel outputs on seeded inputs, to compare two trees' bits.

    python3 kernel_digest.py [--tree DIR]

Imports ``rocm_apex_tpu_torch`` from DIR (default: the directory of this
script), runs on one CUDA device the paged decode read (bf16, fp32 and
int8 pools at pages of 16 and 64: the serve's decode grid and chunk
piece B) and the 3x3 bottleneck backward (ResNet-50's five stride-1
blocks at B 128 in bf16, a ragged M, W 2, a ragged split, and fp32) on
inputs drawn from fixed seeds, and prints one JSON line: the sha256 of
each call's outputs. Two trees whose lines agree give those kernels the
same bits on the same card and PyTorch build. It imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import sys

import torch


def _digest(outs):
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device", file=sys.stderr)
        return 2
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops import fused_bottleneck as fb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    slots, cap, heads, hd = 8, 1024, 8, 128
    lens = torch.tensor([1024, 0, 17, 513, 300, 64, 1000, 129],
                        dtype=torch.int32, device=dev)
    ids = torch.tensor([3] * 97 + [0] * 64 + [5] * 40 + [6] * 32
                       + [slots] * 23, dtype=torch.int32, device=dev)
    for ps in (16, 64):
        pages = slots * cap // ps
        table = torch.randperm(pages, generator=torch.Generator().manual_seed(
            ps)).int().reshape(slots, cap // ps).to(dev)
        shape = (pages, heads, ps, hd)
        for pool in ("bf16", "fp32", "int8"):
            dt = torch.float32 if pool == "fp32" else torch.bfloat16
            if pool == "int8":
                k, v = (torch.randint(-127, 128, shape, generator=gen,
                                      device=dev, dtype=torch.int8)
                        for _ in range(2))
                ks, vs = (0.005 + 0.02 * torch.rand(
                    (pages, heads), generator=gen, device=dev)
                    for _ in range(2))
            else:
                k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                        for _ in range(2))
                ks = vs = None
            for form, rows, sl in (("grid", slots, None),
                                   ("piece B", 256, ids)):
                q = torch.randn(rows, heads, hd, generator=gen,
                                device=dev).to(dt)
                out[f"paged {pool} page {ps} {form}"] = _digest(
                    fa.flash_attention_decode_paged(
                        q, k, v, table, lens, None, ks, vs, return_lse=True,
                        slot_ids=sl))
    for name, n, h, c, dt in (
            ("layer1", 128, 56, 64, torch.bfloat16),
            ("layer2", 128, 28, 128, torch.bfloat16),
            ("layer3", 128, 14, 256, torch.bfloat16),
            ("layer4", 128, 7, 512, torch.bfloat16),
            ("ragged M", 3, 7, 64, torch.bfloat16),
            ("W 2", 4, 2, 64, torch.bfloat16),
            ("ragged split", 3, 13, 128, torch.bfloat16),
            ("fp32", 8, 14, 64, torch.float32)):

        def rnd(*shape, scale=1.0, shift=0.0):
            return (shift + scale * torch.randn(*shape, generator=gen,
                                                device=dev))

        e = rnd(n, h, h, c, scale=1e-2).to(dt)
        x = rnd(n, h, h, c).to(dt)
        y = rnd(n, h, h, c).to(dt)
        w = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5).to(dt)
        kf = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=1e-3),
              rnd(c, scale=1e-3))
        pro = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1))
        red = (rnd(c, scale=0.1), rnd(c, scale=0.1, shift=1.0))
        out[f"conv3 bwd {name}"] = _digest(
            fb.conv3x3_bn_act_bwd(e, w, x, (y, *kf), pro, red))
    torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
