"""Times the forward flash kernels (K1, K1-lse, K8, K13) at the shapes of
their main paths on one CUDA card, so that two checkouts of the port can be
compared on the same card and the same inputs.

    python3 cullavo_tpu_torch/scripts/flash_bench.py [--root DIR] [--rounds N]

``--root`` names the checkout whose ``cullavo_tpu_torch`` is imported
(default: the one holding this file): one copy of this script times an
older checkout's kernels through the entry points both share
(``flash_attention``, ``_flash_cuda``, ``flash_attention_packed``).  Run
it once per checkout in turns (older, newer, newer, older) and compare
within one machine.  The inputs are drawn from a seeded generator on the
card, so every run sees the same bytes.  Each form is timed as the median
of 20 launches between CUDA events, the 50 MB L2 flushed and the card kept
busy ~0.5 ms ahead of each launch, so that the events time the card and not
the wrapper's host work; the forms take turns, ``--rounds`` times.

Shapes (``PERF.md`` §6): K1 at the greedy prefill [7, 32, 648, 128]; K1-lse
at the train step [8, 32, 1024, 128]; K8 with its lse at the attention
probe [6, 32, 648, 128] (positions, 7 right-padded keys, causal); K13 at
[8, 1024, 32*128] and [7, 648, 32*128].  Prints the card's name and power
limit, then one JSON line: ``{"root", "device", "power_limit", "ms": {form:
[median per round]}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
LEAD_CYCLES = 1_000_000


def _bench_ms(torch, fn, device, reps=20):
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _forms(torch, fa, device):
    """name -> a call of one forward form on its inputs (made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    bf, H, d = torch.bfloat16, 32, 128

    def heads(B, T):   # strided head views of [B, T, H, d] projection outputs
        return [torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2)
                for _ in range(3)]

    def packed(B, T):
        return [torch.randn((B, T, H * d), generator=g, device=device).to(bf) for _ in range(3)]

    k1 = heads(7, 648)
    k1_lse = heads(8, 1024)
    k8 = heads(6, 648)
    valid = (torch.arange(648, device=device)[None, :] < 648 - 7).int().expand(6, 648)
    pos = (torch.cumsum(valid, dim=1) - 1).clamp_min(0).int()
    k13_train, k13_prefill = packed(8, 1024), packed(7, 648)
    return {"K1 [7,32,648,128]": lambda: fa.flash_attention(*k1),
            "K1-lse [8,32,1024,128]": lambda: fa._flash_cuda(*k1_lse, None, None, True, True),
            "K8-lse [6,32,648,128] qpos+kvalid causal":
                lambda: fa._flash_cuda(*k8, pos, valid, True, True),
            "K13 [8,1024,32*128]": lambda: fa.flash_attention_packed(*k13_train, H),
            "K13 [7,648,32*128]": lambda: fa.flash_attention_packed(*k13_prefill, H)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="the checkout whose cullavo_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from cullavo_tpu_torch.ops import flash_attention as fa

    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise SystemExit(f"flash_bench: imported {fa.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (x.strip() for x in smi.splitlines()[0].split(","))
    print(smi.splitlines()[0], flush=True)
    forms = _forms(torch, fa, device)
    ms = {n: [] for n in forms}
    for _ in range(args.rounds):
        for n, fn in forms.items():
            ms[n].append(round(_bench_ms(torch, fn, device), 4))
    print(json.dumps({"root": root, "device": name, "power_limit": limit, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
